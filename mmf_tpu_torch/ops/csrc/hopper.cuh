// Hopper (sm_90a) building blocks for the flash-attention kernels (K1, K2,
// K3), the int8 GEMM (K5) and the LayerNorm backward (K4-bwd): mbarriers,
// TMA tile loads and bulk copies, wgmma on 128-byte-swizzled bf16 and int8
// tiles, and the host-side TMA descriptors.
//
// Tile layout. Every operand tile in shared memory is a TMA box of 64 rows
// x 64 bf16 (128 bytes a row) under CU_TENSOR_MAP_SWIZZLE_128B: the 16-byte
// chunk c of row r sits at chunk c ^ (r % 8), and each box starts on a
// 1024-byte boundary. A head dim above 64 takes a second box (columns
// 64..127) 8 KB further on. wgmma reads the same bytes two ways:
//   - K-major (the reduction runs along the row, e.g. q k^T over D):
//     8-row groups 1024 bytes apart (SBO); a k16 step moves the start 32
//     bytes along the row, and the next box after four steps;
//   - MN-major (the reduction runs down the rows, e.g. ds k over kv):
//     the 64 columns of a box are one swizzle atom (LBO: the next box),
//     8-row groups 1024 bytes apart (SBO); a k16 step moves 16 rows, 2048
//     bytes. This is how K2 reads k, and K3 q and dO, as B operands
//     without a transposed copy.
// Accumulators (m64n64k16, f32): warp w of the warpgroup holds rows
// 16 w .. 16 w + 15; lane (g = lane / 4, t = lane % 4) holds, for each
// 8-column block j, d[4 j + 0, 1] at row g, columns 8 j + 2 t, + 1, and
// d[4 j + 2, 3] at row g + 8. A register A operand (m64k16) has the
// mma.m16n8k16 A layout per warp, so two neighbouring accumulator blocks
// repack into it (mmf_flash::pack_bf16).
// int8 (K5): a box row is 128 int8 values of K, and a k32 step of the s8
// wgmma moves 32 bytes along it: the same K-major descriptor arithmetic.
// A box of R rows holds R / 8 groups of 8 rows, 1024 bytes apart, so the
// second warpgroup's 64 rows of a 128-row box start 8 KB in. s32
// accumulators have the f32 layout above.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_runtime.h>
#include <stdint.h>

namespace mmf_hopper {

constexpr int BOX_ROWS = 64;                   // rows of a TMA box
constexpr int BOX_BYTES = BOX_ROWS * 128;      // one swizzled 64 x 64 box

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers -------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Adds `bytes` to the transaction count of the current phase (no arrival).
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed. The polling
// loop lives inside the PTX, so the compiler sees no divergent branch
// around the wgmma that follow. A wait that outlasts 2^26 polls traps, so a
// lost arrival ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done, late;\n.reg .u32 polls;\n"
      "mov.u32 polls, 0;\n"
      "MMF_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra.uni MMF_DONE;\n"
      "add.u32 polls, polls, 1;\n"
      "setp.gt.u32 late, polls, 67108864;\n"
      "@late trap;\n"
      "bra.uni MMF_WAIT;\n"
      "MMF_DONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// The calling thread's warp index, provably the same across the warp, so
// that branches on it are not divergent to the compiler.
__device__ __forceinline__ int warp_uniform_index() {
  return __shfl_sync(0xffffffffu, int(threadIdx.x) >> 5, 0);
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// --- TMA -------------------------------------------------------------------
// One box of a 4-D map (coordinates innermost first) into shared memory;
// completion is counted in bytes on `bar`. Rows and columns outside the
// tensor arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box of a 2-D map (coordinates innermost first), as tma_load.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// `bytes` (a multiple of 16) of contiguous global memory into shared
// memory by one bulk copy (TMA without a tensor map; both addresses
// 16-byte aligned); completion is counted in bytes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One box of a 4-D map from shared memory to global memory (a TMA store,
// in this thread's bulk group; rows and columns outside the tensor are
// not written). The box must be in the map's swizzled layout.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Closes this thread's bulk group of TMA stores.
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until every TMA store this thread committed has read its shared
// memory (the writes to global memory go on; the kernel's end waits for
// them).
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Orders this thread's writes to shared memory before the async proxy's
// reads (a TMA store that follows a barrier).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 4 bytes from global into shared memory (cp.async), zeros when `valid` is
// false (nothing is read then).
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Starts bringing the 128-byte line at `p` into L2 (no register written).
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// Arrives on `bar` once this thread's earlier cp.async copies have landed
// (counts as one of the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// --- wgmma -----------------------------------------------------------------
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) |
         (uint64_t(1) << 62);  // layout: 128-byte swizzle
}

// K-major operand: k16 step kk of a tile whose boxes start at `addr`.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr, int kk) {
  return sw128_desc(addr + (kk >> 2) * BOX_BYTES + (kk & 3) * 32, 16, 1024);
}

// MN-major operand: k16 step kk (rows 16 kk .. 16 kk + 15) of the box at
// `addr` (one 64-column block of the head dim).
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr, int kk) {
  return sw128_desc(addr + kk * 2048, BOX_BYTES, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous products that write it.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define MMF_WG_ACC                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"
#define MMF_WG_OUT(d)                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (+)= A B, m64n64k16, A and B K-major in shared memory; `accumulate`
// 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MMF_WG_ACC
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : MMF_WG_OUT(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, m64n64k16, A (bf16 pairs) in registers, B MN-major in shared
// memory.
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MMF_WG_ACC
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MMF_WG_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef MMF_WG_ACC
#undef MMF_WG_OUT

// Waits until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d += A B, m64nNk32, s8 x s8 -> s32, A and B K-major in shared memory
// (the s8 wgmma takes no other layout); N = 64 (32 accumulators a thread)
// or 128 (64).
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// --- host: TMA descriptors -------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    return (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D map over (D, S, H, B) of a bf16 (or, with `f32`, float32) tensor
// whose (batch, head, seq) element strides are st[0..2] (head dim
// contiguous): boxes of 64 rows x 128 bytes (64 bf16 or 32 f32) under the
// 128-byte swizzle, zeros outside. A dim of size 1 gets a packed stride
// (its stride is never used); a stride that is not a positive multiple of
// 16 bytes is refused.
inline bool make_tile_map(CUtensorMap* map, const void* ptr, int D, int S,
                          int H, int B, const long long* st,
                          bool f32 = false) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t esize = f32 ? 4 : 2;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(S), cuuint64_t(H),
                              cuuint64_t(B)};
  const long long elem[3] = {st[2], st[1], st[0]};  // seq, head, batch
  cuuint64_t strides[3];
  cuuint64_t packed = cuuint64_t(D) * esize;
  for (int i = 0; i < 3; ++i) {
    cuuint64_t s;
    if (dims[i + 1] == 1) {
      s = (packed + 15) / 16 * 16;
    } else {
      if (elem[i] <= 0 || (elem[i] * esize) % 16 != 0) return false;
      s = cuuint64_t(elem[i]) * esize;
    }
    strides[i] = s;
    packed = s * dims[i + 1];
  }
  const cuuint32_t box[4] = {cuuint32_t(128 / esize), BOX_ROWS, 1, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return fn(map,
            f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            4, const_cast<void*>(ptr), dims, strides, box, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 2-D map over a row-major int8 [rows, K] matrix: boxes of `box_rows`
// rows x 128 bytes of K under the 128-byte swizzle, zeros outside (ragged
// rows and the tail of K). K must be a multiple of 16 (TMA's global
// strides are multiples of 16 bytes) and the pointer 16-byte aligned.
inline bool make_int8_map(CUtensorMap* map, const void* ptr, int rows, int K,
                          int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || K <= 0 || K % 16 != 0 || rows <= 0 ||
      reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
    return false;
  const cuuint64_t dims[2] = {cuuint64_t(K), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(K)};
  const cuuint32_t box[2] = {128, cuuint32_t(box_rows)};
  const cuuint32_t one[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
            dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace mmf_hopper
