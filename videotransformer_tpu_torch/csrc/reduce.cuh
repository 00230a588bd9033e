// Deterministic column sums for the backward kernels: out[c] = sum over r
// of in[r][c], in fp32. The TPU kernels add their bias and LayerNorm
// gradients into resident fp32 blocks as the grid runs in order
// (fused_mhsa_pallas.py:416-426, fused_ffn_pallas.py:222-238); on the card
// blocks run in no order, so the sums are two passes with a fixed
// assignment of rows to threads: each thread adds one column of a
// kColChunk-row chunk, top to bottom, then one thread adds the chunk sums
// of its column, in chunk order. No atomics: two runs give the same bits.
// Bandwidth-bound; the reads are coalesced along the row.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vt {

constexpr int kColThreads = 256;
constexpr int kColChunk = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kColThreads)
    colsum_kernel(const T* __restrict__ in, float* __restrict__ out, int R,
                  int N, int rows_per_chunk) {
  const int c = blockIdx.x * kColThreads + threadIdx.x;
  if (c >= N) return;
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(R, r0 + rows_per_chunk);
  float s = 0.0f;
  for (int r = r0; r < r1; ++r) s += to_f32(in[(size_t)r * N + c]);
  out[(size_t)blockIdx.y * N + c] = s;
}

// fp32 floats of scratch launch_colsum needs for R rows of N columns.
inline size_t colsum_scratch(int R, int N) {
  return (size_t)((R + kColChunk - 1) / kColChunk) * N;
}

// out[N] = column sums of in[R][N]; `scratch` holds colsum_scratch(R, N).
template <typename T>
inline cudaError_t launch_colsum(const T* in, float* scratch, float* out,
                                 int R, int N, cudaStream_t stream) {
  const int chunks = (R + kColChunk - 1) / kColChunk;
  const dim3 grid((N + kColThreads - 1) / kColThreads, chunks);
  colsum_kernel<T><<<grid, kColThreads, 0, stream>>>(in, scratch, R, N,
                                                     kColChunk);
  colsum_kernel<float><<<grid.x, kColThreads, 0, stream>>>(scratch, out,
                                                           chunks, N, chunks);
  return cudaGetLastError();
}

}  // namespace vt
