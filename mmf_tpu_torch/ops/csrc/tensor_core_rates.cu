// Peak rates of the tensor-core instructions an f32 kernel can use on
// Hopper: mma.sync m16n8k8 tf32 (and m16n8k16 bf16 beside it) and wgmma
// m64n64k8 tf32 from shared memory, each with independent accumulators so
// that only the unit's rate bounds it. Built and run by
// mmf_tpu_torch/ops/tensor_core_rates.py; prints TFLOP/s a line.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

__global__ void __launch_bounds__(256) mma_tf32(float* out, int iters) {
  float d[8][4];
  for (int j = 0; j < 8; ++j) for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
  uint32_t a0 = threadIdx.x, a1 = a0 + 1, a2 = a0 + 2, a3 = a0 + 3, b0 = 7, b1 = 9;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
                   : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  float s = 0; for (int j = 0; j < 8; ++j) for (int e = 0; e < 4; ++e) s += d[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void __launch_bounds__(256) mma_bf16(float* out, int iters) {
  float d[8][4];
  for (int j = 0; j < 8; ++j) for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
  uint32_t a0 = threadIdx.x, a1 = a0 + 1, a2 = a0 + 2, a3 = a0 + 3, b0 = 7, b1 = 9;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
                   : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  float s = 0; for (int j = 0; j < 8; ++j) for (int e = 0; e < 4; ++e) s += d[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// one warpgroup a block; acc 64x64 f32 (32 regs a thread); 8 k-steps a group
__global__ void __launch_bounds__(128) wgmma_tf32(float* out, int iters) {
  __shared__ __align__(1024) float sa[64 * 32], sb[64 * 32];
  for (int i = threadIdx.x; i < 64 * 32; i += 128) { sa[i] = 0.f; sb[i] = 0.f; }
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  float d[32];
  for (int e = 0; e < 32; ++e) d[e] = 0.f;
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(sa), b = (uint32_t)__cvta_generic_to_shared(sb);
  for (int i = 0; i < iters; ++i) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = desc(a + 32 * kk), db = desc(b + 32 * kk);
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
          "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
          "%32, %33, p, 1, 1;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
            "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
            "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
            "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
          : "l"(da), "l"(db), "r"(1));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  float s = 0; for (int e = 0; e < 32; ++e) s += d[e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <typename K>
double run(K kernel, int blocks, int threads, int iters, double flop_per_iter_block, float* out) {
  kernel<<<blocks, threads>>>(out, 10);
  cudaDeviceSynchronize();
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  cudaEventRecord(e0);
  kernel<<<blocks, threads>>>(out, iters);
  cudaEventRecord(e1); cudaEventSynchronize(e1);
  float ms; cudaEventElapsedTime(&ms, e0, e1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) printf("error %s\n", cudaGetErrorString(err));
  return blocks * flop_per_iter_block * iters / (ms * 1e-3) / 1e12;
}

int main() {
  float* out; cudaMalloc(&out, 132 * 8 * 256 * sizeof(float));
  for (int warps : {4, 8}) {
    for (int bps : {1, 2, 4}) {
      int blocks = 132 * bps, threads = 32 * warps;
      printf("mma.sync tf32 m16n8k8: %d warps x %d blocks/SM: %.1f TFLOP/s\n", warps, bps,
             run(mma_tf32, blocks, threads, 4096, warps * 8 * 2048.0, out));
      printf("mma.sync bf16 m16n8k16: %d warps x %d blocks/SM: %.1f TFLOP/s\n", warps, bps,
             run(mma_bf16, blocks, threads, 4096, warps * 8 * 4096.0, out));
    }
  }
  for (int bps : {1, 2, 3, 4})
    printf("wgmma tf32 m64n64k8 (4 per group): %d warpgroups/SM: %.1f TFLOP/s\n", bps,
           run(wgmma_tf32, 132 * bps, 128, 4096, 4 * 65536.0, out));
  return 0;
}
