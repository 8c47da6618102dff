// Device helpers shared by the flash-attention forward (K1) and backward
// (K2, K3) kernels: warp reductions, bf16 packing and the 16-byte
// alignment check (bf16 operands, the f32 backward's TMA maps). An m16n8k16
// accumulator row pair packs (pack_bf16) into wgmma's register A operand,
// whose per-warp layout hopper.cuh describes.

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

inline bool aligned16(const void* p, const long long* strides,
                      int elem_bytes = 2) {
  // rows are loaded as 16-byte vectors (and by TMA)
  if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (int i = 0; i < 3; ++i)
    if (strides[i] * elem_bytes % 16 != 0) return false;
  return true;
}

}  // namespace mmf_flash
