// bf16 GEMM tile shared by the port's fused kernels (fused_mhsa.cu,
// fused_ffn.cu), and the mma.sync helpers the attention kernel uses too.
//
//   C[M, N] = epilogue(A[M, K] · W[N, K]ᵀ + bias[N])
//
// A is row-major activations, W a weight in nn.Linear's (out, in) layout,
// so both operands are K-major. bf16 in, fp32 accumulate on the tensor cores
// (mma.sync m16n8k16), rounded to bf16 once, in the epilogue, after the bias
// (and the GELU or the residual) -- the rounding order of the TPU kernels'
// `jnp.dot(..., preferred_element_type=f32) + b` bodies.
//
// Tiling: 128x128 block tile, 8 warps of 64x32, K step 64, three
// shared-memory stages filled with cp.async (16 bytes a thread) so two K
// steps load while the tensor cores work on a third, and two blocks per SM
// so one block's epilogue overlaps another's main loop; fragments come from
// shared memory through ldmatrix, and rows padded to 72 elements make those
// reads conflict-free. Rows past M and columns past N are zero-filled on
// load and masked on store; K must be a multiple of 64 and N of 8.
// mma.sync reaches part of Hopper's rate only: wgmma/TMA and a persistent
// schedule are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vt {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;          // block tile rows (M)
constexpr int kBN = 128;          // block tile cols (N)
constexpr int kBK = 64;           // K step
constexpr int kLd = kBK + 8;      // padded smem row (elements): 144 bytes
constexpr int kStages = 3;
constexpr int kGemmThreads = 256;
constexpr int kWarpM = kBM / 2;   // 2 x 4 warps
constexpr int kWarpN = kBN / 4;
constexpr int kMT = kWarpM / 16;  // m16 tiles per warp
constexpr int kNT = kWarpN / 8;   // n8 tiles per warp
constexpr size_t kGemmSmem =
    (size_t)kStages * (kBM + kBN) * kLd * sizeof(bf16);  // 110592 bytes

enum Epilogue { kBias = 0, kBiasGelu = 1, kBiasResidual = 2 };

// ---- PTX helpers -----------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // src-size 0: write 16 zero bytes, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lane l gives the address of row (l % 8) of matrix
// (l / 8), and receives its share of each in r[0..3].
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// c (16x8 fp32) += a (16x16 bf16, row) · b (16x8 bf16, col). Fragment
// layout (PTX ISA, m16n8k16): with g = lane / 4 and t = lane % 4, a holds
// rows g, g+8 x cols 2t, 2t+1 (a0, a1) and cols 2t+8, 2t+9 (a2, a3); b holds
// k = 2t, 2t+1 (b0) and 2t+8, 2t+9 (b1) of col g; c holds row g (c0, c1)
// and row g+8 (c2, c3), cols 2t, 2t+1.
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// ---- the GEMM ----------------------------------------------------------------

// `rows` x kBK tile of a row-major (limit, K) matrix into smem (row stride
// kLd); rows at or past `limit` are zero-filled.
template <int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0,
                                          int limit, int K, int k0) {
  constexpr int kChunksPerRow = kBK / 8;
  for (int c = threadIdx.x; c < ROWS * kChunksPerRow; c += kGemmThreads) {
    const int r = c / kChunksPerRow;
    const int col = (c % kChunksPerRow) * 8;
    const int g = row0 + r;
    const bool valid = g < limit;
    const bf16* p = src + (size_t)(valid ? g : 0) * K + k0 + col;
    cp_async16(dst + r * kLd + col, p, valid);
  }
}

template <int EPI>
__global__ void __launch_bounds__(kGemmThreads, 2)
    gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                     const bf16* __restrict__ bias,
                     const bf16* __restrict__ resid, bf16* __restrict__ C,
                     int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char gemm_smem[];
  bf16* As = reinterpret_cast<bf16*>(gemm_smem);  // [kStages][kBM][kLd]
  bf16* Bs = As + kStages * kBM * kLd;             // [kStages][kBN][kLd]

  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / 4;  // 2 x 4 warps, each owns kWarpM x kWarpN
  const int wn = warp % 4;

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int ktiles = K / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) {
      load_tile<kBM>(As + s * kBM * kLd, A, m0, M, K, s * kBK);
      load_tile<kBN>(Bs + s * kBN * kLd, W, n0, N, K, s * kBK);
    }
    cp_async_commit();
  }

  // ldmatrix row addresses of this lane (see ldmatrix_x4): A tiles are
  // 16 rows x 16 k (matrices: rows 0-7/8-15 x k 0-7, then k 8-15); B tiles
  // are 16 n x 16 k (matrices: n 0-7 x k 0-7, k 8-15, then n 8-15).
  const int a_row = wm * kWarpM + (lane & 15);
  const int a_col = (lane >> 4) * 8;
  const int b_row = wn * kWarpN + (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) * 8;

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();  // K step kt has landed (this thread's)
    __syncthreads();               // ... everyone's; stage kt-1 is free
    const int pre = kt + kStages - 1;
    if (pre < ktiles) {
      const int ps = pre % kStages;
      load_tile<kBM>(As + ps * kBM * kLd, A, m0, M, K, pre * kBK);
      load_tile<kBN>(Bs + ps * kBN * kLd, W, n0, N, K, pre * kBK);
    }
    cp_async_commit();  // possibly empty group: keeps the count uniform

    const bf16* a = As + (kt % kStages) * kBM * kLd;
    const bf16* b = Bs + (kt % kStages) * kBN * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t fa[kMT][4], fb[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
        ldmatrix_x4(fa[i], a + (a_row + i * 16) * kLd + kk + a_col);
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j) {
        uint32_t r[4];
        ldmatrix_x4(r, b + (b_row + j * 16) * kLd + kk + b_col);
        fb[2 * j][0] = r[0];
        fb[2 * j][1] = r[1];
        fb[2 * j + 1][0] = r[2];
        fb[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_16816(acc[i][j], fa[i], fb[j]);
    }
  }
  cp_async_wait<0>();

  // Epilogue from registers: two adjacent columns per thread and row.
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int gn = n0 + wn * kWarpN + j * 8 + t * 2;
    if (gn >= N) continue;
    const float2 bv = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(bias + gn));
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int gm = m0 + wm * kWarpM + i * 16 + g + half * 8;
        if (gm >= M) continue;
        float v0 = acc[i][j][2 * half] + bv.x;
        float v1 = acc[i][j][2 * half + 1] + bv.y;
        if (EPI == kBiasGelu) {
          v0 = gelu_erf(v0);
          v1 = gelu_erf(v1);
        }
        const size_t off = (size_t)gm * N + gn;
        if (EPI == kBiasResidual) {
          const float2 rv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(resid + off));
          v0 += rv.x;
          v1 += rv.y;
        }
        *reinterpret_cast<__nv_bfloat162*>(C + off) =
            __floats2bfloat162_rn(v0, v1);
      }
  }
}

template <int EPI>
inline cudaError_t launch_gemm(const bf16* A, const bf16* W, const bf16* bias,
                               const bf16* resid, bf16* C, int M, int N, int K,
                               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_bf16_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kGemmSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_bf16_kernel<EPI><<<grid, kGemmThreads, kGemmSmem, stream>>>(
      A, W, bias, resid, C, M, N, K);
  return cudaGetLastError();
}

}  // namespace vt
