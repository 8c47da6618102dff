// Device helpers shared by the flash-attention forward (K1) and backward
// (K2, K3) kernels: warp reductions, bf16 packing, the forward's
// tensor-core product mma.sync m16n8k16 and the bf16 alignment check.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane (g = lane / 4,
// t = lane % 4) holds
//   A (16 x 16, row-major): rows g and g + 8, columns 2 t, 2 t + 1 and
//     2 t + 8, 2 t + 9, as a0 (g, 2t), a1 (g + 8, 2t), a2 (g, 2t + 8),
//     a3 (g + 8, 2t + 8), each a pair of bf16;
//   B (16 x 8, "col"): column g, rows 2 t, 2 t + 1 (b0) and 2 t + 8,
//     2 t + 9 (b1), so B is read from a [n][k] tile, contiguous in k;
//   C/D (16 x 8, f32): rows g (c0, c1) and g + 8 (c2, c3), columns 2 t,
//     2 t + 1.
// Two neighbouring C fragments (columns 16 kc .. 16 kc + 15) therefore
// repack in place (pack_bf16) into the A fragment of the next product;
// wgmma's register A operand (hopper.cuh) has the same layout per warp.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mmf_flash {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float max_xor(float x, int width) {
  for (int off = width / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float sum_xor(float x, int width) {
  for (int off = width / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);  // two bf16, 4-byte aligned
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

inline bool aligned16(const void* p, const long long* strides) {
  // bf16 rows are loaded as 16-byte vectors
  if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (int i = 0; i < 3; ++i)
    if (strides[i] % 8 != 0) return false;
  return true;
}

}  // namespace mmf_flash
