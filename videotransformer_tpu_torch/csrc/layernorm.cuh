// Row LayerNorm for the port's prenorm kernels: one warp per row, fp32
// statistics (two passes: mean, then mean of squared deviations), output
// rounded to bf16 -- the order of the TPU kernels
// (fused_mhsa_pallas.py:141-146, fused_ffn_pallas.py:68-73):
//   xn = bf16(((x - mean) * rsqrt(var + eps)) * w + b)
// Memory-bound: it reads the row three times (the later reads hit L1).
//
// The backward (fused_mhsa_pallas.py:403-414, fused_ffn_pallas.py:213-220):
//   xhat = (x - mean) * rstd, dxhat = dxn * w,
//   dx   = bf16(rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) [+ g])
// all in fp32, one warp per row, with the weight and bias gradients
// (sum over rows of dxn * xhat and of dxn) kept per warp in registers and
// written as one partial row per warp; reduce.cuh sums the partials in a
// fixed order, so the result does not depend on the blocks' schedule.
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

constexpr int kLnBwdRowsPerWarp = 8;
constexpr int kLnBwdWarps = kLnThreads / 32;
constexpr int kLnBwdRowsPerBlock = kLnBwdRowsPerWarp * kLnBwdWarps;
constexpr int kLnMaxPerLane = 32;  // D <= 1024

// Partial rows (one per warp) the backward over `rows` rows writes.
inline int layernorm_bwd_part_rows(int rows) {
  return (rows + kLnBwdRowsPerBlock - 1) / kLnBwdRowsPerBlock * kLnBwdWarps;
}

__global__ void __launch_bounds__(kLnThreads)
    layernorm_bwd_kernel(const __nv_bfloat16* __restrict__ x,
                         const float* __restrict__ dxn,
                         const __nv_bfloat16* __restrict__ w,
                         const __nv_bfloat16* __restrict__ g_res,
                         __nv_bfloat16* __restrict__ dx,
                         float* __restrict__ part_w,
                         float* __restrict__ part_b, int rows, int D,
                         float eps) {
  const int gw = (blockIdx.x * kLnThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  float acc_w[kLnMaxPerLane], acc_b[kLnMaxPerLane];
  float xv[kLnMaxPerLane], dv[kLnMaxPerLane];
#pragma unroll
  for (int j = 0; j < kLnMaxPerLane; ++j) acc_w[j] = acc_b[j] = 0.0f;
  for (int rr = 0; rr < kLnBwdRowsPerWarp; ++rr) {
    const int row = gw * kLnBwdRowsPerWarp + rr;
    if (row >= rows) break;  // whole warp leaves together
    const __nv_bfloat16* xr = x + (size_t)row * D;
    const float* dr = dxn + (size_t)row * D;
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < kLnMaxPerLane; ++j) {
      const int c = j * 32 + lane;
      xv[j] = c < D ? __bfloat162float(xr[c]) : 0.0f;
      dv[j] = c < D ? dr[c] : 0.0f;
      s += xv[j];
    }
    const float mean = warp_sum(s) / D;
    float v = 0.0f;
#pragma unroll
    for (int j = 0; j < kLnMaxPerLane; ++j) {
      const int c = j * 32 + lane;
      const float d = c < D ? xv[j] - mean : 0.0f;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / D + eps);
    float m1 = 0.0f, m2 = 0.0f;
#pragma unroll
    for (int j = 0; j < kLnMaxPerLane; ++j) {
      const int c = j * 32 + lane;
      if (c < D) {
        xv[j] = (xv[j] - mean) * rstd;  // xhat from here on
        acc_w[j] += dv[j] * xv[j];
        acc_b[j] += dv[j];
        dv[j] *= __bfloat162float(w[c]);  // dxhat from here on
        m1 += dv[j];
        m2 += dv[j] * xv[j];
      }
    }
    m1 = warp_sum(m1) / D;
    m2 = warp_sum(m2) / D;
    __nv_bfloat16* out = dx + (size_t)row * D;
#pragma unroll
    for (int j = 0; j < kLnMaxPerLane; ++j) {
      const int c = j * 32 + lane;
      if (c < D) {
        float o = rstd * (dv[j] - m1 - xv[j] * m2);
        if (g_res) o += __bfloat162float(g_res[(size_t)row * D + c]);
        out[c] = __float2bfloat16(o);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kLnMaxPerLane; ++j) {
    const int c = j * 32 + lane;
    if (c < D) {
      part_w[(size_t)gw * D + c] = acc_w[j];
      part_b[(size_t)gw * D + c] = acc_b[j];
    }
  }
}

// dx (+ g_res when not null) and the per-warp partials of the weight and
// bias gradients, layernorm_bwd_part_rows(rows) rows of D each.
inline cudaError_t launch_layernorm_bwd(const __nv_bfloat16* x,
                                        const float* dxn,
                                        const __nv_bfloat16* w,
                                        const __nv_bfloat16* g_res,
                                        __nv_bfloat16* dx, float* part_w,
                                        float* part_b, int rows, int D,
                                        float eps, cudaStream_t stream) {
  if (D > 32 * kLnMaxPerLane) return cudaErrorInvalidValue;
  const int blocks = (rows + kLnBwdRowsPerBlock - 1) / kLnBwdRowsPerBlock;
  layernorm_bwd_kernel<<<blocks, kLnThreads, 0, stream>>>(
      x, dxn, w, g_res, dx, part_w, part_b, rows, D, eps);
  return cudaGetLastError();
}

}  // namespace vt
