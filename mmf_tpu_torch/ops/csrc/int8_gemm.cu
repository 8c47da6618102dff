// int8 GEMM with the dequantising epilogue for Hopper (sm_90a): K5.
//
// Replaces the Pallas TPU kernel mmf_tpu/ops/quant.py::_dequant_gemm_kernel
// (launched from _dequant_gemm_pallas). Same function:
//   out[m, n] = cast_out(float(sum_k x8[m, k] * w8[n, k]) * (xs[m] * ws[n])
//                        + bias[n])
// with int8 operands, an exact int32 sum (|sum| <= K * 127^2 < 2^31 for the
// K the entry point takes), f32 per-row activation scales xs, f32
// per-output-channel weight scales ws, an optional f32 bias, and a bfloat16
// or float32 output. The weight is the port's [N, K] layout (K contiguous),
// which is exactly the B operand of mma.sync ... .row.col: no transposed
// copy is made.
//
// What bounds it on the H100: at the trunk's shapes (K, N in {768, 3072})
// with M = 131 (MMBT, batch 1) each weight byte is used by at most 131 rows,
// under the ~590 int8 operations per byte at which the 1979 TOP/s tensor
// cores overtake the 3.35 TB/s memory: the weight read bounds it. At M =
// 7296 (VisualBERT, bucket 32) the operations bound it. Design (a simple
// kernel that is right; wgmma for s8, TMA and a pipelined ring are later
// work):
//   - one block of 4 warps per 64 x 64 output tile; it loops over K in
//     64-byte slabs, each staged through shared memory with 16-byte loads
//     (rows padded to 80 bytes, so the fragment loads below are free of
//     bank conflicts);
//   - each warp owns a 32 x 32 sub-tile: 2 x 4 mma.sync m16n8k32 (s8 x s8
//     -> s32) per 32-byte step of K, int32 accumulators in registers;
//   - the epilogue converts each int32 sum to f32 and applies the scales
//     and the bias in the plain version's order, y * (xs * ws) + b, with
//     round-to-nearest intrinsics so that no multiply-add is contracted,
//     and writes the output dtype straight from registers;
//   - ragged M and N edges are masked in the kernel (zero-filled operand
//     rows, no stores outside the output); K must be a multiple of 16
//     (whole 16-byte vectors), and a ragged last slab is zero-filled.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (mmf_tpu_torch/ops/_build.py); plain C entry
//        point loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // output rows per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 64;        // bytes of K per shared-memory slab
constexpr int LDS = BK + 16;  // padded slab row, bytes
constexpr int THREADS = 128;  // 4 warps, 2 x 2 over the tile
constexpr int VECS = BK / 16;  // 16-byte vectors per slab row

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);  // four int8, 4-byte aligned
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Fragment layouts (PTX ISA, mma.m16n8k32 with .s8): lane (g = lane / 4,
// t = lane % 4) holds
//   A (16 x 32, row-major): a0 row g, bytes 4t..4t+3; a1 row g + 8, the
//     same bytes; a2 row g, bytes 16 + 4t..; a3 row g + 8, bytes 16 + 4t..;
//   B (32 x 8, "col"): column g, bytes 4t.. (b0) and 16 + 4t.. (b1) of K,
//     so B is read from a [n][k] tile, contiguous in k;
//   C/D (16 x 8, s32): rows g (c0, c1) and g + 8 (c2, c3), columns 2t,
//     2t + 1.
template <typename OutT>
__global__ void __launch_bounds__(THREADS)
int8_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ xs, const float* __restrict__ ws,
                 const float* __restrict__ bias, OutT* __restrict__ out,
                 int M, int N, int K) {
  __shared__ __align__(16) int8_t as[BM * LDS];
  __shared__ __align__(16) int8_t bs[BN * LDS];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // every warp is done with the previous slab
    for (int idx = threadIdx.x; idx < BM * VECS; idx += THREADS) {
      const int r = idx / VECS, c = (idx % VECS) * 16;
      const int kk = k0 + c;
      const int gm = m0 + r, gn = n0 + r;
      *reinterpret_cast<uint4*>(as + r * LDS + c) =
          (gm < M && kk < K)
              ? *reinterpret_cast<const uint4*>(x + (long long)gm * K + kk)
              : zero;
      *reinterpret_cast<uint4*>(bs + r * LDS + c) =
          (gn < N && kk < K)
              ? *reinterpret_cast<const uint4*>(w + (long long)gn * K + kk)
              : zero;
    }
    __syncthreads();

#pragma unroll
    for (int kc = 0; kc < BK; kc += 32) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* p = as + (wm + 16 * i + g) * LDS + kc + 4 * t;
        af[i][0] = ld32(p);
        af[i][1] = ld32(p + 8 * LDS);
        af[i][2] = ld32(p + 16);
        af[i][3] = ld32(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = bs + (wn + 8 * j + g) * LDS + kc + 4 * t;
        bf[j][0] = ld32(p);
        bf[j][1] = ld32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int row = m0 + wm + 16 * i + g + 8 * e2;
      if (row >= M) continue;
      const float sx = xs[row];
      OutT* orow = out + (long long)row * N;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int col = n0 + wn + 8 * j + 2 * t + e1;
          if (col >= N) continue;
          float v = __fmul_rn(__int2float_rn(acc[i][j][2 * e2 + e1]),
                              __fmul_rn(sx, ws[col]));
          if (bias != nullptr) v = __fadd_rn(v, bias[col]);
          store_out(orow + col, v);
        }
    }
}

template <typename OutT>
cudaError_t launch(const void* x, const void* w, const float* xs,
                   const float* ws, const float* bias, void* out, int M,
                   int N, int K, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_gemm_kernel<OutT><<<grid, THREADS, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), xs, ws,
      bias, static_cast<OutT*>(out), M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x8: int8 [M, K] row-major; w8: int8 [N, K] row-major (one row per output
// channel); xs: f32 [M]; ws: f32 [N]; bias: f32 [N] or null; out: [M, N]
// row-major, float32 (out_dtype 0) or bfloat16 (out_dtype 1). K must be a
// positive multiple of 16 with K * 127^2 < 2^31, and x8, w8 16-byte
// aligned. Launches on `stream`, allocates nothing, returns
// cudaGetLastError() (or cudaErrorInvalidValue /
// cudaErrorMisalignedAddress for arguments the kernel does not take).
int mmf_int8_gemm(const void* x8, const void* w8, const float* xs,
                  const float* ws, const float* bias, void* out,
                  int out_dtype, int M, int N, int K, void* stream) {
  if (M < 0 || N < 0 || K <= 0 || K % 16 != 0 ||
      (long long)K * 127 * 127 >= (1LL << 31) ||
      (M + BM - 1) / BM > 65535 || (out_dtype != 0 && out_dtype != 1))
    return int(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(x8) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w8) % 16 != 0)
    return int(cudaErrorMisalignedAddress);
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 1)
    return int(launch<__nv_bfloat16>(x8, w8, xs, ws, bias, out, M, N, K, s));
  return int(launch<float>(x8, w8, xs, ws, bias, out, M, N, K, s));
}

const char* mmf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
