// int8 GEMM with the dequantising epilogue for Hopper (sm_90a): K5.
//
// Replaces the Pallas TPU kernel mmf_tpu/ops/quant.py::_dequant_gemm_kernel
// (launched from _dequant_gemm_pallas). Same function:
//   out[m, n] = cast_out(float(sum_k x8[m, k] * w8[n, k]) * (xs[m] * ws[n])
//                        + bias[n])
// with int8 operands, an exact int32 sum (|sum| <= K * 127^2 < 2^31 for the
// K the entry point takes), f32 per-row activation scales xs, f32
// per-output-channel weight scales ws, an optional f32 bias, and a bfloat16
// or float32 output. x8 [M, K] and the port's [N, K] weight are both
// K-major, the only layout the s8 wgmma takes: no copy is made.
//
// What bounds it on the H100: at M = 7296 (VisualBERT, bucket 32) the
// int8 operations against the 1979 TOP/s tensor cores (bf16 output) or
// the output's bytes (f32), and in practice the traffic from L2 into
// shared memory; at M = 131 and 1 (MMBT at batch 1) each weight byte is
// used by at most 131 rows, under the ~590 operations per byte at which
// the tensor cores overtake the 3.35 TB/s memory, so the weight read
// bounds it, and a launch is a few microseconds of latency. Design
// (warp-specialised; layouts in hopper.cuh):
//   - a block is WG consumer warpgroups (64 output rows each) and one
//     producer warp; the producer streams 128-byte slabs of K of the x8
//     and w8 tiles through a ring of shared-memory stages by TMA (128-byte
//     swizzle, zeros outside the matrices, so ragged M, N and K need no
//     masks in the main loop); mbarriers count the bytes;
//   - the consumers run wgmma m64nNk32 s8 x s8 -> s32 from shared memory,
//     keeping one stage's products in flight while the next stage's are
//     issued, and free a stage when its products are done;
//   - large M: 128 x 128 output tiles, two consumer warpgroups, a 3-stage
//     ring, two blocks an SM; small M (where those tiles would leave SMs
//     idle): 64 x 64 tiles, one consumer warpgroup, a 4-stage ring, three
//     blocks an SM. The wrapper (ops/quant.py, k5_tile) chooses from the
//     shapes. Measured and dropped: 128 x 256 tiles (slower at every
//     VisualBERT shape) and a split of K over the blocks of a thread-block
//     cluster at small M (the cluster launch cost more than the shorter
//     K loop saved at every MMBT shape);
//   - the epilogue converts each int32 sum to f32 and applies the scales
//     and the bias in the plain version's order, y * (xs * ws) + b, with
//     round-to-nearest intrinsics so that no multiply-add is contracted,
//     into a padded row-major tile in shared memory (the idle ring), then
//     copies it out in 16-byte chunks, masked at the ragged edges (writing
//     straight from the accumulator layout left each 32-byte sector half
//     written in bf16). No atomics: two runs give the same bits.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (mmf_tpu_torch/ops/_build.py); plain C entry
//        point loaded with ctypes. TMA descriptors are encoded per call
//        with cuTensorMapEncodeTiled through the runtime's
//        cudaGetDriverEntryPoint, so the library needs no -lcuda.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace mmf_hopper;

constexpr int SLAB = 128;    // bytes of K a stage holds (one swizzled row)
constexpr int ALIGN = 1024;  // swizzled boxes start on 1 KB

struct Args {
  const float *xs, *ws, *bias;  // bias: null for none
  void* out;
  int M, N, K;
};

__device__ __forceinline__ void store_out2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_out2(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The epilogue of one element, in the plain version's order.
__device__ __forceinline__ float dequant(int y, float sx, float sw,
                                         const float* bias, int col) {
  const float v = __fmul_rn(__int2float_rn(y), __fmul_rn(sx, sw));
  return bias == nullptr ? v : __fadd_rn(v, bias[col]);
}

template <int WG, int BN, int STAGES>
struct Layout {
  static constexpr int BM = 64 * WG;
  static constexpr int CONSUMERS = 128 * WG;
  static constexpr int THREADS = CONSUMERS + 32;
  static constexpr int A_BYTES = BM * SLAB;
  static constexpr int STAGE = A_BYTES + BN * SLAB;
  static constexpr int BARS = STAGES * STAGE;
  static constexpr int BYTES = BARS + 2 * STAGES * 8 + ALIGN;
};

// One block: output rows m0 .. m0 + BM - 1, columns n0 .. n0 + BN - 1.
template <int WG, int BN, int STAGES, typename OutT, int MIN_BLOCKS>
__global__ void __launch_bounds__(Layout<WG, BN, STAGES>::THREADS, MIN_BLOCKS)
    int8_gemm_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap wmap,
                          const Args a) {
  using Lay = Layout<WG, BN, STAGES>;
  constexpr int NACC = BN / 2;  // s32 accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((ALIGN - smem_u32(smem_raw) % ALIGN) % ALIGN);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + Lay::BARS);
  uint64_t* empty = full + STAGES;

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * Lay::BM;
  const int n_t = (a.K + SLAB - 1) / SLAB;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], Lay::CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // producer warp: lane 0 keeps the ring filled
  if (warp_uniform_index() >= Lay::CONSUMERS / 32) {
    if ((threadIdx.x & 31) == 0)
      for (int t = 0; t < n_t; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);
        unsigned char* st = base + s * Lay::STAGE;
        mbar_arrive_expect_tx(&full[s], Lay::STAGE);
        tma_load_2d(st, &xmap, &full[s], t * SLAB, m0);
        tma_load_2d(st + Lay::A_BYTES, &wmap, &full[s], t * SLAB, n0);
      }
    return;
  }

  // consumers: warpgroup wg owns output rows m0 + 64 wg .. + 63
  const int tid = threadIdx.x, wg = tid >> 7;
  int acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0;
  for (int t = 0; t < n_t; ++t) {
    const int s = t % STAGES;
    mbar_wait(&full[s], (t / STAGES) & 1);
    const uint32_t a_addr = smem_u32(base + s * Lay::STAGE) + wg * BOX_BYTES;
    const uint32_t b_addr = smem_u32(base + s * Lay::STAGE + Lay::A_BYTES);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < SLAB / 32; ++kk)
      wgmma_s8(acc, kmajor_desc(a_addr, kk), kmajor_desc(b_addr, kk));
    wg_commit();
    // the previous stage's products are done: free its stage
    wg_wait<1>();
    if (t > 0) mbar_arrive(&empty[(t - 1) % STAGES]);
  }
  wg_wait<0>();
  fence_acc(acc);

  // epilogue: dequantise this lane's rows (r, r + 8; column pairs
  // 8 j + 2 t4) into shared memory, a padded row-major tile in the output
  // dtype (the ring is idle once every consumer's products are done), then
  // copy it out in 16-byte chunks, whole rows of a warp at a time
  named_barrier(1, Lay::CONSUMERS);
  constexpr int CH = 16 / sizeof(OutT);  // elements a chunk
  constexpr int LDO = BN + CH;           // padded row: conflict-free pairs
  static_assert(Lay::BM * LDO * sizeof(OutT) <= Lay::BARS,
                "the output tile fits in the ring");
  OutT* tile = reinterpret_cast<OutT*>(base);
  const int g = (tid & 31) >> 2, t4 = tid & 3;
  const int r_loc = 64 * wg + 16 * ((tid >> 5) & 3) + g;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rl = r_loc + 8 * i;
    const float sx = a.xs[min(m0 + rl, a.M - 1)];  // rows past M: unused
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * t4;
      const int c0 = min(n0 + c, a.N - 1), c1 = min(n0 + c + 1, a.N - 1);
      store_out2(tile + rl * LDO + c,
                 dequant(acc[4 * j + 2 * i], sx, a.ws[c0], a.bias, c0),
                 dequant(acc[4 * j + 2 * i + 1], sx, a.ws[c1], a.bias, c1));
    }
  }
  named_barrier(1, Lay::CONSUMERS);
  constexpr int CPR = BN / CH;  // chunks a row
  const bool whole = (a.N * sizeof(OutT)) % 16 == 0;  // aligned chunks
  OutT* out = static_cast<OutT*>(a.out);
  for (int idx = tid; idx < Lay::BM * CPR; idx += Lay::CONSUMERS) {
    const int r = idx / CPR, c = (idx % CPR) * CH;
    const int row = m0 + r, col = n0 + c;
    if (row >= a.M || col >= a.N) continue;
    const OutT* src = tile + r * LDO + c;
    OutT* dst = out + (long long)row * a.N + col;
    if (whole && col + CH <= a.N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < CH && col + e < a.N; ++e) dst[e] = src[e];
    }
  }
}

// tile 128: 128 x 128 output tiles; tile 64: 64 x 64
template <int WG, int BN, int STAGES, typename OutT, int MIN_BLOCKS>
cudaError_t launch(const void* x8, const void* w8, const Args& a,
                   cudaStream_t stream) {
  using Lay = Layout<WG, BN, STAGES>;
  CUtensorMap xmap, wmap;
  if (!make_int8_map(&xmap, x8, a.M, a.K, Lay::BM) ||
      !make_int8_map(&wmap, w8, a.N, a.K, BN))
    return cudaErrorInvalidValue;
  auto kernel = int8_gemm_sm90_kernel<WG, BN, STAGES, OutT, MIN_BLOCKS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((a.N + BN - 1) / BN, (a.M + Lay::BM - 1) / Lay::BM);
  kernel<<<grid, Lay::THREADS, Lay::BYTES, stream>>>(xmap, wmap, a);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_tile(int tile, const void* x8, const void* w8,
                        const Args& a, cudaStream_t s) {
  return tile == 128 ? launch<2, 128, 3, OutT, 2>(x8, w8, a, s)
                     : launch<1, 64, 4, OutT, 3>(x8, w8, a, s);
}

}  // namespace

extern "C" {

// x8: int8 [M, K] row-major; w8: int8 [N, K] row-major (one row per output
// channel); xs: f32 [M]; ws: f32 [N]; bias: f32 [N] or null; out: [M, N]
// row-major, float32 (out_dtype 0) or bfloat16 (out_dtype 1). K must be a
// positive multiple of 16 with K * 127^2 < 2^31, and x8, w8 16-byte
// aligned. tile: 128 (128 x 128 output tiles) or 64 (64 x 64). Launches
// on `stream`, allocates nothing, returns cudaGetLastError() (or
// cudaErrorInvalidValue / cudaErrorMisalignedAddress for arguments the
// kernel does not take).
int mmf_int8_gemm(const void* x8, const void* w8, const float* xs,
                  const float* ws, const float* bias, void* out,
                  int out_dtype, int M, int N, int K, int tile,
                  void* stream) {
  if (M < 0 || N < 0 || K <= 0 || K % 16 != 0 ||
      (long long)K * 127 * 127 >= (1LL << 31) ||
      (tile != 64 && tile != 128) || (M + tile - 1) / tile > 65535 ||
      (out_dtype != 0 && out_dtype != 1))
    return int(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(x8) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w8) % 16 != 0)
    return int(cudaErrorMisalignedAddress);
  if (M == 0 || N == 0) return 0;
  Args a{xs, ws, bias, out, M, N, K};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 1)
    return int(launch_tile<__nv_bfloat16>(tile, x8, w8, a, s));
  return int(launch_tile<float>(tile, x8, w8, a, s));
}

const char* mmf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
