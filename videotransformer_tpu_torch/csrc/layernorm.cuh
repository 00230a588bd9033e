// Row LayerNorm for the port's prenorm kernels: one warp per row, fp32
// statistics (two passes: mean, then mean of squared deviations), output
// rounded to bf16 -- the order of the TPU kernels
// (fused_mhsa_pallas.py:141-146, fused_ffn_pallas.py:68-73):
//   xn = bf16(((x - mean) * rsqrt(var + eps)) * w + b)
// Memory-bound: it reads the row three times (the later reads hit L1). The
// backward is bwd_common.cuh's.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vt {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

constexpr int kLnThreads = 256;

__global__ void __launch_bounds__(kLnThreads)
    layernorm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ w,
                          const __nv_bfloat16* __restrict__ b,
                          __nv_bfloat16* __restrict__ y, int rows, int D,
                          float eps) {
  const int row = (blockIdx.x * kLnThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warp leaves together
  const __nv_bfloat16* xr = x + (size_t)row * D;
  float s = 0.0f;
  for (int i = lane; i < D; i += 32) s += __bfloat162float(xr[i]);
  const float mean = warp_sum(s) / D;
  float v = 0.0f;
  for (int i = lane; i < D; i += 32) {
    const float d = __bfloat162float(xr[i]) - mean;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / D + eps);
  __nv_bfloat16* yr = y + (size_t)row * D;
  for (int i = lane; i < D; i += 32)
    yr[i] = __float2bfloat16((__bfloat162float(xr[i]) - mean) * rstd *
                                 __bfloat162float(w[i]) +
                             __bfloat162float(b[i]));
}

inline cudaError_t launch_layernorm(const __nv_bfloat16* x,
                                    const __nv_bfloat16* w,
                                    const __nv_bfloat16* b, __nv_bfloat16* y,
                                    int rows, int D, float eps,
                                    cudaStream_t stream) {
  const int rows_per_block = kLnThreads / 32;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  layernorm_bf16_kernel<<<blocks, kLnThreads, 0, stream>>>(x, w, b, y, rows, D,
                                                          eps);
  return cudaGetLastError();
}

}  // namespace vt
