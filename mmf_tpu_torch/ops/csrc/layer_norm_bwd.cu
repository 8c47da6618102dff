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
// Design:
//   - the statistics are recomputed from x and r, which the backward reads
//     anyway, so the forward writes nothing beside y;
//   - one warp a row (up to 1024 columns; wider rows take 2, 4 or 8 warps
//     of one block, their partial sums met in shared memory); a lane holds
//     its columns as 16-byte vectors, lane l taking vectors l, l + 32, ...
//     so that a warp's loads are contiguous: at H = 768 three vectors a
//     lane in bf16, six in f32. h stays in registers in f32 and dy in its
//     16-byte form; the row's three sums (h, (h - mean)^2, then g and
//     g xhat together) are butterfly shuffles, with no shared memory and
//     no barrier when one warp holds the row;
//   - a persistent grid (as many 256-thread blocks as fit on the card, at
//     most one row step each) whose warps stride over the rows; each lane
//     sums dy xhat and dy of its columns over all its rows in registers;
//     at the end a block adds its warps' sums in shared memory, in warp
//     order, and writes one f32 row of dscale and one of dbias partials;
//   - a second small kernel adds the partials over the blocks in a fixed
//     order. No atomics anywhere: two calls give the same bits.
// Any hidden size: rows are laid out with a stride ld, H rounded up to
// whole 16-byte vectors, the columns past H zero (x, r, dy and the scale;
// the wrapper pads a ragged width), and the centred sum of squares masks
// them; those columns of dx and of the partials are never read. Rows wider
// than 8192 take ln_bwd_wide_kernel: one block a row, four passes over the
// row (sum, centred squares, the g sums, dx) that re-read it from L2
// instead of holding it in registers, each thread adding its columns' dy
// xhat and dy into its block's partial rows in place.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (mmf_tpu_torch/ops/_build.py); plain C entry
//        points loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxHidden = 8192;  // 8 warps x 32 lanes x 32 columns
constexpr int kSlices = 8;        // row slices of the partials' reduction

// A 16-byte vector of T: kN elements, held raw, read and written as f32.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  using Raw = float4;
  __device__ __forceinline__ static Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
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
    return __ldg(reinterpret_cast<const uint4*>(p));
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
    return __ldg(reinterpret_cast<const uint4*>(p));
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

// Sums of the N values v over the WPR warps that hold one row (every lane
// gets the same bits: a butterfly adds each pair in both lanes alike).
// buf: this row group's [WPR][2] slots; each of a row step's three sums
// has its own buffer, so that the barriers between them keep reuse safe.
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
    __syncthreads();
#pragma unroll
    for (int n = 0; n < N; ++n) {
      v[n] = 0.f;
#pragma unroll
      for (int k = 0; k < WPR; ++k) v[n] += buf[k][n];
    }
  }
}

// VPL: 16-byte vectors a lane holds of a row; WPR: warps a row.
// Two blocks an SM where a lane holds at most 24 columns (H = 768 in both
// dtypes), else one. Rows of ld elements, the first H of them real.
template <typename T, int VPL, int WPR>
__global__ void __launch_bounds__(kThreads, (VPL * Vec<T>::kN <= 24) ? 2 : 1)
    ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                  const float* __restrict__ w, const T* __restrict__ dy,
                  T* __restrict__ dx, float* __restrict__ part, int rows,
                  int H, int ld, float eps) {
  using V = Vec<T>;
  constexpr int E = V::kN;
  constexpr int G = kWarps / WPR;          // rows a block holds at once
  constexpr int kCols = 32 * WPR * VPL * E;  // the widest row it takes
  __shared__ float red[3][G][WPR][2];
  __shared__ float colbuf[kCols];

  const int warp = threadIdx.x >> 5;
  const int group = warp / WPR, wpart = warp % WPR;
  const int first = wpart * 32 + (threadIdx.x & 31);  // first vector
  const int nvec = ld / E;
  const float inv_h = 1.f / static_cast<float>(H);
  bool valid[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) valid[i] = first + 32 * WPR * i < nvec;

  float acc_s[VPL][E], acc_b[VPL][E];
#pragma unroll
  for (int i = 0; i < VPL; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) acc_s[i][e] = acc_b[i][e] = 0.f;

  // the loop is uniform over the block: every thread meets the barriers
  // of the multi-warp rows
  for (long long base = static_cast<long long>(blockIdx.x) * G; base < rows;
       base += static_cast<long long>(gridDim.x) * G) {
    const long long row = base + group;
    const bool active = row < rows;
    const size_t off = static_cast<size_t>(active ? row : 0) * ld;
    float h[VPL][E];
    typename V::Raw draw[VPL];
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int col = (first + 32 * WPR * i) * E;
      if (active && valid[i]) {
        V::unpack(V::load(x + off + col), h[i]);
        draw[i] = V::load(dy + off + col);
        if (res != nullptr) {
          float r[E];
          V::unpack(V::load(res + off + col), r);
#pragma unroll
          for (int e = 0; e < E; ++e) h[i][e] += r[e];
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) h[i][e] = 0.f;
        draw[i] = typename V::Raw{};
      }
    }
    float sum[1] = {0.f};
#pragma unroll
    for (int i = 0; i < VPL; ++i)
#pragma unroll
      for (int e = 0; e < E; ++e) sum[0] += h[i][e];
    row_sum<WPR>(sum, red[0][group], wpart);
    const float mean = sum[0] / static_cast<float>(H);
    float sq[1] = {0.f};
    // the squares skip the zero-padded tail of a ragged width; whole rows
    // (ld == H, a uniform branch) keep a loop without the element mask,
    // which in the one loop cost spills and 3% at H = 768 in bf16
    if (ld == H) {
#pragma unroll
      for (int i = 0; i < VPL; ++i)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float c = valid[i] ? h[i][e] - mean : 0.f;
          sq[0] += c * c;
        }
    } else {
#pragma unroll
      for (int i = 0; i < VPL; ++i)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float c =
              (first + 32 * WPR * i) * E + e < H ? h[i][e] - mean : 0.f;
          sq[0] += c * c;
        }
    }
    row_sum<WPR>(sq, red[1][group], wpart);
    const float rstd = 1.f / sqrtf(sq[0] / static_cast<float>(H) + eps);
    float sg[2] = {0.f, 0.f};  // sum of g, sum of g xhat
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int col = (first + 32 * WPR * i) * E;
      float d[E], wv[E];
      V::unpack(draw[i], d);
      if (valid[i]) {
        load_scale<E>(w, col, wv);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) wv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < E; ++e) {
        h[i][e] = (h[i][e] - mean) * rstd;  // xhat from here on
        const float g = d[e] * wv[e];
        sg[0] += g;
        sg[1] += g * h[i][e];
      }
    }
    row_sum<WPR>(sg, red[2][group], wpart);
    const float mg = sg[0] * inv_h, mgx = sg[1] * inv_h;
    if (active) {
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        if (!valid[i]) continue;
        const int col = (first + 32 * WPR * i) * E;
        float d[E], wv[E], out[E];
        V::unpack(draw[i], d);
        load_scale<E>(w, col, wv);
#pragma unroll
        for (int e = 0; e < E; ++e)
          out[e] = rstd * (d[e] * wv[e] - mg - h[i][e] * mgx);
        V::store(dx + off + col, out);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          acc_s[i][e] += d[e] * h[i][e];
          acc_b[i][e] += d[e];
        }
      }
    }
  }

  // this block's column sums: the row groups added in order, then one
  // f32 row each of the dscale and dbias partials ([2][gridDim.x][ld])
  for (int which = 0; which < 2; ++which) {
    for (int g = 0; g < G; ++g) {
      if (group == g) {
#pragma unroll
        for (int i = 0; i < VPL; ++i) {
          if (!valid[i]) continue;
          const int col = (first + 32 * WPR * i) * E;
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float v = which == 0 ? acc_s[i][e] : acc_b[i][e];
            colbuf[col + e] = g == 0 ? v : colbuf[col + e] + v;
          }
        }
      }
      __syncthreads();
    }
    float* out =
        part + (static_cast<size_t>(which) * gridDim.x + blockIdx.x) * ld;
    for (int c = threadIdx.x; c < ld; c += kThreads) out[c] = colbuf[c];
    __syncthreads();
  }
}

// Rows wider than kMaxHidden: one block a row (rows blockIdx.x,
// blockIdx.x + gridDim.x, ...), four passes over it, re-read from L2. The
// block's partial rows of dscale and dbias are summed in place in part,
// row after row: thread t owns the columns of vectors t, t + kThreads, ...
// of both, so no two threads touch one entry. Needs gridDim.x <= rows (the
// first row writes the partials).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_wide_kernel(const T* __restrict__ x, const T* __restrict__ res,
                       const float* __restrict__ w, const T* __restrict__ dy,
                       T* __restrict__ dx, float* __restrict__ part, int rows,
                       int H, int ld, float eps) {
  using V = Vec<T>;
  constexpr int E = V::kN;
  __shared__ float red[3][kWarps][2];
  const int nvec = ld / E, wpart = threadIdx.x >> 5;
  const float inv_h = 1.f / static_cast<float>(H);
  float* ps = part + static_cast<size_t>(blockIdx.x) * ld;
  float* pb = part + (static_cast<size_t>(gridDim.x) + blockIdx.x) * ld;
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
    for (int v = threadIdx.x; v < nvec; v += kThreads) {
      float h[E];
      load_h(v * E, h);
#pragma unroll
      for (int e = 0; e < E; ++e) sum[0] += h[e];
    }
    row_sum<kWarps>(sum, red[0], wpart);
    const float mean = sum[0] / static_cast<float>(H);
    float sq[1] = {0.f};
    for (int v = threadIdx.x; v < nvec; v += kThreads) {
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
    for (int v = threadIdx.x; v < nvec; v += kThreads) {
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
    for (int v = threadIdx.x; v < nvec; v += kThreads) {
      const int col = v * E;
      float h[E], d[E], wv[E], out[E];
      load_h(col, h);
      V::unpack(V::load(dy + off + col), d);
      load_scale<E>(w, col, wv);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float xhat = (h[e] - mean) * rstd;
        out[e] = rstd * (d[e] * wv[e] - mg - xhat * mgx);
        ps[col + e] = (first_row ? 0.f : ps[col + e]) + d[e] * xhat;
        pb[col + e] = (first_row ? 0.f : pb[col + e]) + d[e];
      }
      V::store(dx + off + col, out);
    }
  }
}

// dscale and dbias: part [2][nblk][H] summed over nblk in a fixed order;
// a block takes 32 columns of one of the two, kSlices warps each a
// strided share of the blocks, met in shared memory in slice order.
__global__ void __launch_bounds__(32 * kSlices)
    ln_bwd_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                         float* __restrict__ db, int nblk, int H) {
  __shared__ float buf[kSlices][33];
  const int lane = threadIdx.x & 31, slice = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const float* p = part + static_cast<size_t>(blockIdx.y) * nblk * H;
  float acc = 0.f;
  if (c < H) {
#pragma unroll 4
    for (int b = slice; b < nblk; b += kSlices)
      acc += p[static_cast<size_t>(b) * H + c];
  }
  buf[slice][lane] = acc;
  __syncthreads();
  if (slice == 0 && c < H) {
    float t = 0.f;
#pragma unroll
    for (int s = 0; s < kSlices; ++s) t += buf[s][lane];
    (blockIdx.y == 0 ? dw : db)[c] = t;
  }
}

template <typename T>
using BwdKernel = void (*)(const T*, const T*, const float*, const T*, T*,
                           float*, int, int, int, float);

// The kernel for rows of ld elements of T (ld a positive multiple of 16
// bytes), and the rows a block takes per step; null for another ld.
template <typename T>
BwdKernel<T> pick(int ld, int* rows_per_step) {
  constexpr int E = Vec<T>::kN, VMAX = 32 / E;  // 32 columns a lane
  if (ld <= 0 || ld % E != 0) return nullptr;
  *rows_per_step = 1;
  if (ld > kMaxHidden) return ln_bwd_wide_kernel<T>;
  const int nvec = ld / E;
  *rows_per_step = kWarps;
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
    *rows_per_step = kWarps / 2;
    return ln_bwd_kernel<T, VMAX, 2>;
  }
  if (nvec <= 4 * 32 * VMAX) {
    *rows_per_step = kWarps / 4;
    return ln_bwd_kernel<T, VMAX, 4>;
  }
  *rows_per_step = 1;
  return ln_bwd_kernel<T, VMAX, 8>;
}

template <typename T>
cudaError_t geometry(int ld, int* blocks_per_sm, int* rows_per_step) {
  const BwdKernel<T> k = pick<T>(ld, rows_per_step);
  if (k == nullptr) return cudaErrorInvalidValue;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, reinterpret_cast<const void*>(k), kThreads, 0);
  // the wide kernel's partials are [2, grid, ld] f32: two blocks an SM
  if (ld > kMaxHidden && *blocks_per_sm > 2) *blocks_per_sm = 2;
  return e;
}

template <typename T>
cudaError_t launch(const void* x, const void* res, const float* w,
                   const void* dy, void* dx, float* part, float* dw,
                   float* db, int rows, int H, int ld, float eps, int grid,
                   cudaStream_t s) {
  int step = 1;
  const BwdKernel<T> k = pick<T>(ld, &step);
  if (k == nullptr) return cudaErrorInvalidValue;
  if (ld > kMaxHidden && grid > rows) return cudaErrorInvalidValue;
  k<<<grid, kThreads, 0, s>>>(static_cast<const T*>(x),
                              static_cast<const T*>(res), w,
                              static_cast<const T*>(dy), static_cast<T*>(dx),
                              part, rows, H, ld, eps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ln_bwd_reduce_kernel<<<dim3((ld + 31) / 32, 2), 32 * kSlices, 0, s>>>(
      part, dw, db, grid, ld);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// For dtype 0 (float32), 1 (bfloat16) or 2 (float16) and a row stride ld
// (a positive multiple of 16 bytes): the blocks of the main kernel one SM
// holds and the rows a block takes per step. Returns a cudaError
// (cudaErrorInvalidValue for another dtype or ld).
int mmf_layer_norm_bwd_geometry(int dtype, int ld, int* blocks_per_sm,
                                int* rows_per_step) {
  if (dtype == 0) return int(geometry<float>(ld, blocks_per_sm, rows_per_step));
  if (dtype == 1)
    return int(geometry<__nv_bfloat16>(ld, blocks_per_sm, rows_per_step));
  if (dtype == 2)
    return int(geometry<__half>(ld, blocks_per_sm, rows_per_step));
  return int(cudaErrorInvalidValue);
}

// x, res (or null), dy, dx: [rows, ld] row-major in dtype, 16-byte
// aligned, ld a multiple of 16 bytes, columns H .. ld - 1 of x, res and
// dy zero; w: f32 [ld] (the scale, zero past H); part: f32 [2, grid, ld]
// scratch; dw, db: f32 [ld] out (entries past H meaningless, as are
// dx's). rows >= 1, 1 <= grid (<= rows for ld over 8192). Launches the two
// kernels on `stream`, allocates nothing, returns cudaGetLastError() (or
// cudaErrorInvalidValue / cudaErrorMisalignedAddress for arguments they
// do not take).
int mmf_layer_norm_bwd(const void* x, const void* res, const float* w,
                       const void* dy, void* dx, float* part, float* dw,
                       float* db, int dtype, int rows, int H, int ld,
                       float eps, int grid, void* stream) {
  if (rows < 1 || H < 1 || H > ld || grid < 1 || grid > (1 << 20) ||
      part == nullptr)
    return int(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(res) |
       reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(dy) |
       reinterpret_cast<uintptr_t>(dx)) % 16 != 0)
    return int(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int(launch<float>(x, res, w, dy, dx, part, dw, db, rows, H, ld,
                             eps, grid, s));
  if (dtype == 1)
    return int(launch<__nv_bfloat16>(x, res, w, dy, dx, part, dw, db, rows, H,
                                     ld, eps, grid, s));
  if (dtype == 2)
    return int(launch<__half>(x, res, w, dy, dx, part, dw, db, rows, H, ld,
                              eps, grid, s));
  return int(cudaErrorInvalidValue);
}

const char* mmf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
