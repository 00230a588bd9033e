// Pieces shared by the fused backward kernels (fused_mhsa_bwd.cu, B3, and
// fused_ffn_bwd.cu, B4): the LayerNorm backward with its weight and bias
// gradients as per-warp partial rows, and ordered column sums that reduce
// those partials, the bias gradients and the split-K slices of the weight
// gradients.
//
// The TPU kernels add their bias and LayerNorm gradients into resident fp32
// blocks as the grid runs in order (fused_mhsa_pallas.py:416-426,
// fused_ffn_pallas.py:222-238); on the card blocks run in no order, so every
// sum here has a fixed assignment of rows to threads and a fixed order. No
// atomics: two runs give the same bits. Both are bandwidth-bound.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "layernorm.cuh"  // warp_sum
#include "sm90_gemm.cuh"  // wg::kBK (k tiles of the split-K slices)

namespace vt {
namespace bwd {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void bf16x8_to_float(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 v = __bfloat1622float2(b2[e]);
    f[2 * e] = v.x;
    f[2 * e + 1] = v.y;
  }
}

// ---- column sums ------------------------------------------------------------

constexpr int kSumThreads = 256;
constexpr int kSumChunk = 32;  // rows a thread adds in the first pass
constexpr int kMaxSlices = kSumChunk;

// out[N] = column sums of in[R][N] (bf16 or fp32; N a multiple of 8, rows
// 16-byte aligned): the first pass adds each kSumChunk-row chunk of a column
// top to bottom (into `out` when there is one chunk, else into
// part[chunk][N]), each thread eight neighbouring columns with 16-byte
// loads; the second takes 32 columns a block: warp w adds the chunk sums w,
// w + 8, ... of its lane's column in order, then warp 0 adds the eight
// warps' sums in order.
struct SumJob {
  const void* in;
  float* out;
  float* part;
  int in_bf16, R, N, chunks;
};

constexpr int kMaxJobs = 6;
struct SumJobs {
  SumJob job[kMaxJobs];
  int n;
};

__host__ __device__ inline int col_blocks(const SumJob& j) {
  return (j.N / 8 + kSumThreads - 1) / kSumThreads;
}

__host__ __device__ inline int pass_blocks(const SumJob& j, int pass) {
  if (pass == 1) return j.chunks * col_blocks(j);
  return j.chunks > 1 ? (j.N + 31) / 32 : 0;
}

__global__ void __launch_bounds__(kSumThreads)
    colsum_jobs_kernel(const SumJobs jobs, int pass) {
  int b = blockIdx.x, k = 0;
  for (; k < jobs.n; ++k) {
    const int nb = pass_blocks(jobs.job[k], pass);
    if (b < nb) break;
    b -= nb;
  }
  if (k == jobs.n) return;
  const SumJob& j = jobs.job[k];
  float s = 0.0f;
  if (pass == 2) {
    __shared__ float warp_sums[kSumThreads / 32][32];
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int c = b * 32 + lane;
    if (c < j.N)
      for (int q = warp; q < j.chunks; q += kSumThreads / 32)
        s += j.part[(size_t)q * j.N + c];
    warp_sums[warp][lane] = s;
    __syncthreads();
    if (warp == 0 && c < j.N) {
      float t = 0.0f;
#pragma unroll
      for (int w = 0; w < kSumThreads / 32; ++w) t += warp_sums[w][lane];
      j.out[c] = t;
    }
    return;
  }
  const int cb = col_blocks(j);
  const int chunk = b / cb;
  const int c = ((b % cb) * kSumThreads + threadIdx.x) * 8;
  if (c >= j.N) return;
  const int r1 = min(j.R, (chunk + 1) * kSumChunk);
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
#pragma unroll 4
  for (int r = chunk * kSumChunk; r < r1; ++r) {
    const size_t off = (size_t)r * j.N + c;
    float v[8];
    if (j.in_bf16) {
      bf16x8_to_float(
          __ldg(reinterpret_cast<const uint4*>(static_cast<const bf16*>(j.in) +
                                               off)),
          v);
    } else {
      const float4* in = reinterpret_cast<const float4*>(
          static_cast<const float*>(j.in) + off);
      const float4 a = __ldg(in), b4 = __ldg(in + 1);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b4.x; v[5] = b4.y; v[6] = b4.z; v[7] = b4.w;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] += v[e];
  }
  float4* dst = reinterpret_cast<float4*>(
      (j.chunks == 1 ? j.out : j.part + (size_t)chunk * j.N) + c);
  dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

inline int chunks_of(int R) { return (R + kSumChunk - 1) / kSumChunk; }

// fp32 floats of chunk sums a job over R x N needs.
inline size_t chunk_floats(int R, int N) {
  return chunks_of(R) > 1 ? (size_t)chunks_of(R) * N : 0;
}

// Jobs that share one scratch area for their chunk sums (chunk_floats each).
struct SumPlan {
  SumJobs jobs{};
  float* chunk;
  bool bad = false;  // a job the kernel does not take (run refuses)
  explicit SumPlan(float* scratch) : chunk(scratch) {}
  void add(const void* in, bool is_bf16, int R, int N, float* out) {
    if (N % 8 || jobs.n == kMaxJobs) {
      bad = true;
      return;
    }
    SumJob& j = jobs.job[jobs.n++];
    j.in = in;
    j.out = out;
    j.in_bf16 = is_bf16;
    j.R = R;
    j.N = N;
    j.chunks = chunks_of(R);
    j.part = chunk;
    chunk += chunk_floats(R, N);
  }
  // Both passes, for all jobs together: two launches at most.
  cudaError_t run(cudaStream_t st) const {
    if (bad) return cudaErrorInvalidValue;
    for (int pass = 1; pass <= 2; ++pass) {
      int blocks = 0;
      for (int k = 0; k < jobs.n; ++k) blocks += pass_blocks(jobs.job[k], pass);
      if (blocks == 0) continue;
      colsum_jobs_kernel<<<blocks, kSumThreads, 0, st>>>(jobs, pass);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
  }
};

// Slices of a split-K weight gradient: `slices` of `per` 64-row k tiles
// cover the K rows, none empty, and one chunk of the ordered sum takes them.
inline bool slices_cover(int slices, int per, int K) {
  const int ktiles = (K + wg::kBK - 1) / wg::kBK;
  return slices >= 1 && slices <= kMaxSlices && per >= 1 &&
         (long long)slices * per >= ktiles &&
         (long long)(slices - 1) * per < ktiles;
}

// ---- LayerNorm backward -------------------------------------------------------

// (fused_mhsa_pallas.py:403-414, fused_ffn_pallas.py:213-220), one warp a row:
//   xhat = (x - mean) * rstd, dxhat = dxn * w,
//   dx   = bf16(rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) [+ g])
// in fp32, with the statistics recomputed as layernorm.cuh computes them
// (the mean, then the mean of squared deviations); g, the residual's
// gradient, is added before the rounding when it is not null. Lane l holds
// the 8-column chunks l, l + 32, ... (16-byte loads of x and g, 32-byte of
// dxn); each warp adds the weight and bias gradients of its kLnbRows rows
// in registers and writes them as one partial row.
constexpr int kLnbRows = 8;

inline int ln_bwd_part_rows(int rows) { return (rows + kLnbRows - 1) / kLnbRows; }

template <int CPL>  // 8-column chunks a lane: D <= 256 * CPL
__global__ void __launch_bounds__(256)
    ln_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ dxn,
                  const bf16* __restrict__ w, const bf16* __restrict__ g_res,
                  bf16* __restrict__ dx, float* __restrict__ part_w,
                  float* __restrict__ part_b, int rows, int D, float eps) {
  const int gw = (blockIdx.x * 256 + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (gw * kLnbRows >= rows) return;  // whole warp leaves together
  float aw[CPL][8], ab[CPL][8], wv[CPL][8];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int col = (lane + 32 * c) * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) aw[c][e] = ab[c][e] = wv[c][e] = 0.0f;
    if (col < D)
      bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(w + col)), wv[c]);
  }
  for (int rr = 0; rr < kLnbRows; ++rr) {
    const int row = gw * kLnbRows + rr;
    if (row >= rows) break;
    float xv[CPL][8], dv[CPL][8];
    float sx = 0.0f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int col = (lane + 32 * c) * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) xv[c][e] = dv[c][e] = 0.0f;
      if (col < D) {
        const size_t off = (size_t)row * D + col;
        bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(x + off)), xv[c]);
        const float4 d0 = __ldg(reinterpret_cast<const float4*>(dxn + off));
        const float4 d1 = __ldg(reinterpret_cast<const float4*>(dxn + off + 4));
        dv[c][0] = d0.x; dv[c][1] = d0.y; dv[c][2] = d0.z; dv[c][3] = d0.w;
        dv[c][4] = d1.x; dv[c][5] = d1.y; dv[c][6] = d1.z; dv[c][7] = d1.w;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) sx += xv[c][e];
    }
    const float mean = warp_sum(sx) / D;
    float sq = 0.0f;
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      if ((lane + 32 * c) * 8 < D)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = xv[c][e] - mean;
          sq += d * d;
        }
    const float rstd = rsqrtf(warp_sum(sq) / D + eps);
    float m1 = 0.0f, m2 = 0.0f;
#pragma unroll
    for (int c = 0; c < CPL; ++c)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        xv[c][e] = (xv[c][e] - mean) * rstd;  // xhat from here on
        aw[c][e] += dv[c][e] * xv[c][e];
        ab[c][e] += dv[c][e];
        dv[c][e] *= wv[c][e];  // dxhat from here on
        m1 += dv[c][e];
        m2 += dv[c][e] * xv[c][e];
      }
    m1 = warp_sum(m1) / D;
    m2 = warp_sum(m2) / D;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int col = (lane + 32 * c) * 8;
      if (col >= D) continue;
      const size_t off = (size_t)row * D + col;
      float gv[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) gv[e] = 0.0f;
      if (g_res)
        bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(g_res + off)), gv);
      uint4 u;
      __nv_bfloat162* b2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        b2[e] = __floats2bfloat162_rn(
            rstd * (dv[c][2 * e] - m1 - xv[c][2 * e] * m2) + gv[2 * e],
            rstd * (dv[c][2 * e + 1] - m1 - xv[c][2 * e + 1] * m2) +
                gv[2 * e + 1]);
      *reinterpret_cast<uint4*>(dx + off) = u;
    }
  }
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int col = (lane + 32 * c) * 8;
    if (col >= D) continue;
    float* pw = part_w + (size_t)gw * D + col;
    float* pb = part_b + (size_t)gw * D + col;
#pragma unroll
    for (int e = 0; e < 8; e += 4) {
      *reinterpret_cast<float4*>(pw + e) =
          make_float4(aw[c][e], aw[c][e + 1], aw[c][e + 2], aw[c][e + 3]);
      *reinterpret_cast<float4*>(pb + e) =
          make_float4(ab[c][e], ab[c][e + 1], ab[c][e + 2], ab[c][e + 3]);
    }
  }
}

// dx (+ g_res where it is not null) and ln_bwd_part_rows(rows) partial rows
// of D each of the weight and bias gradients; D a multiple of 8, <= 1024.
inline cudaError_t launch_ln_bwd(const bf16* x, const float* dxn,
                                 const bf16* w, const bf16* g_res, bf16* dx,
                                 float* part_w, float* part_b, int rows, int D,
                                 float eps, cudaStream_t st) {
  const int blocks = (ln_bwd_part_rows(rows) + 7) / 8;
  if (D % 8 || D > 1024) return cudaErrorInvalidValue;
  if (D <= 256)
    ln_bwd_kernel<1><<<blocks, 256, 0, st>>>(x, dxn, w, g_res, dx, part_w,
                                             part_b, rows, D, eps);
  else if (D <= 512)
    ln_bwd_kernel<2><<<blocks, 256, 0, st>>>(x, dxn, w, g_res, dx, part_w,
                                             part_b, rows, D, eps);
  else if (D <= 768)
    ln_bwd_kernel<3><<<blocks, 256, 0, st>>>(x, dxn, w, g_res, dx, part_w,
                                             part_b, rows, D, eps);
  else
    ln_bwd_kernel<4><<<blocks, 256, 0, st>>>(x, dxn, w, g_res, dx, part_w,
                                             part_b, rows, D, eps);
  return cudaGetLastError();
}

}  // namespace bwd
}  // namespace vt
