// bf16 GEMM tile shared by the port's fused kernels (fused_mhsa.cu,
// fused_ffn.cu and their backward files), and the mma.sync helpers the
// attention kernels use too.
//
//   C[M, N] = epilogue(A · B (+ bias[N]))
//
// Operand layouts (template flags):
//   A_T = false: A row-major [M][K] (activations, K contiguous)
//   A_T = true:  A stored [K][M] (M contiguous): the transposed activations
//                of a weight gradient, e.g. dW1 = dh_preᵀ · xn
//   B_T = false: B given as W[N][K], nn.Linear's (out, in) layout (K-major)
//   B_T = true:  B given as [K][N] (N contiguous): a weight read N-major, as
//                in dxn = dh_pre · W1, or the activations of a weight
//                gradient (K = the row count)
// Both transposed layouts are loaded into shared memory as they lie (k rows
// of 128 m or n) and turned into mma fragments by ldmatrix.trans, so no
// transpose pass touches device memory.
//
// bf16 in, fp32 accumulate on the tensor cores (mma.sync m16n8k16), rounded
// once, in the epilogue, after the bias (and the GELU or the residual) --
// the rounding order of the TPU kernels' `jnp.dot(..., f32) + b` bodies.
// The fp32 epilogues (weight gradients, d_xn) store the accumulator as it is.
// A weight gradient is one GEMM whose K is the row count, so every output
// element is summed by one thread in a fixed order: no cross-block sums, no
// atomics, the same bits on every run.
//
// Tiling: 128x128 block tile, 8 warps of 64x32, K step 64, three
// shared-memory stages filled with cp.async (16 bytes a thread) so two K
// steps load while the tensor cores work on a third, and two blocks per SM
// so one block's epilogue overlaps another's main loop. K-major tiles are
// rows padded to 72 elements, transposed tiles rows of 136: both make the
// ldmatrix reads conflict-free. Rows past M and columns past N are
// zero-filled on load and masked on store; M and N must be multiples of 8.
// K must be a multiple of 64 where an operand is K-major (every product but
// a weight gradient's); a transposed operand zero-fills k past K, so a
// weight gradient takes any row count that is a multiple of 8, and only its
// loads pay for the check. mma.sync reaches part of Hopper's rate only:
// wgmma/TMA and a persistent schedule are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vt {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;          // block tile rows (M)
constexpr int kBN = 128;          // block tile cols (N)
constexpr int kBK = 64;           // K step
constexpr int kLd = kBK + 8;      // padded K-major smem row: 144 bytes
constexpr int kLdT = kBM + 8;     // padded transposed smem row: 272 bytes
constexpr int kStages = 3;
constexpr int kGemmThreads = 256;
constexpr int kWarpM = kBM / 2;   // 2 x 4 warps
constexpr int kWarpN = kBN / 4;
constexpr int kMT = kWarpM / 16;  // m16 tiles per warp
constexpr int kNT = kWarpN / 8;   // n8 tiles per warp
constexpr int kTileElems =
    kBM * kLd > kBK * kLdT ? kBM * kLd : kBK * kLdT;  // one operand, one stage
constexpr size_t kGemmSmem =
    (size_t)kStages * 2 * kTileElems * sizeof(bf16);  // 110592 bytes

enum Epilogue {
  kBias = 0,          // bf16(acc + bias)
  kBiasGelu = 1,      // bf16(gelu(acc + bias))
  kBiasResidual = 2,  // bf16(acc + bias + aux_in)
  kBiasGeluSave = 3,  // aux_out = bf16(acc + bias); C = bf16(gelu(acc + bias))
  kF32 = 4,           // C (fp32) = acc
  kGeluBwd = 5,       // d = acc * gelu'(aux_in); C = bf16(d);
                      // aux_out = bf16(gelu(aux_in)); col_part += d by column
};

struct GemmParams {
  const bf16* A;
  const bf16* B;
  const bf16* bias;    // [N], bias epilogues
  const bf16* aux_in;  // [M][N]: residual (kBiasResidual), h_pre (kGeluBwd)
  void* C;             // [M][N]: bf16, fp32 for kF32
  bf16* aux_out;       // [M][N]: kBiasGeluSave, kGeluBwd
  float* col_part;     // kGeluBwd: [2 * gridDim.y][N] column partial sums
  int M, N, K;
};

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

// The same, each matrix transposed on the way: lane (g, t) receives
// elements [2t][g] and [2t+1][g] of each stored 8x8 matrix.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* smem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

// A fragments of a 16x16 tile stored row-major [m][k] (row stride ld).
__device__ __forceinline__ void load_a_mk(uint32_t* a, const bf16* base,
                                          int ld, int lane) {
  ldmatrix_x4(a, base + (lane & 15) * ld + (lane >> 4) * 8);
}

// A fragments of a 16x16 tile stored [k][m] (row stride ld).
__device__ __forceinline__ void load_a_km(uint32_t* a, const bf16* base,
                                          int ld, int lane) {
  ldmatrix_x4_trans(
      a, base + ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8);
}

// B fragments of two n8 tiles (16 n x 16 k) stored [n][k]: b[0..1] for
// n 0-7, b[2..3] for n 8-15.
__device__ __forceinline__ void load_b_nk(uint32_t* b, const bf16* base,
                                          int ld, int lane) {
  ldmatrix_x4(b,
              base + ((lane & 7) + ((lane >> 4) << 3)) * ld +
                  ((lane >> 3) & 1) * 8);
}

// B fragments of two n8 tiles (16 k x 16 n) stored [k][n]: b[0..1] for
// n 0-7, b[2..3] for n 8-15.
__device__ __forceinline__ void load_b_kn(uint32_t* b, const bf16* base,
                                          int ld, int lane) {
  ldmatrix_x4_trans(
      b, base + ((lane & 7) + (((lane >> 3) & 1) << 3)) * ld + (lane >> 4) * 8);
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// d/dv of the exact erf-GELU (fused_ffn_pallas.py::_gelu_grad), with erff.
__device__ __forceinline__ float gelu_erf_grad(float v) {
  const float cdf = 0.5f * (1.0f + erff(v * 0.70710678118654752f));
  const float pdf = expf(-0.5f * v * v) * 0.39894228040143268f;
  return cdf + v * pdf;
}

// ---- the GEMM ----------------------------------------------------------------

// ROWS x kBK tile of a row-major (limit, K) matrix into smem (row stride
// kLd); rows at or past `limit` are zero-filled. K is a multiple of kBK.
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

// kBK x 128 tile of a row-major (K, limit) matrix into smem (row stride
// kLdT): k rows k0.., columns col0..; past K or `limit` zero-filled.
__device__ __forceinline__ void load_tile_t(bf16* dst, const bf16* src,
                                            int col0, int limit, int K,
                                            int k0) {
  constexpr int kChunksPerRow = kBM / 8;
  for (int c = threadIdx.x; c < kBK * kChunksPerRow; c += kGemmThreads) {
    const int r = c / kChunksPerRow;
    const int col = (c % kChunksPerRow) * 8;
    const bool valid = k0 + r < K && col0 + col < limit;
    const bf16* p = src + (valid ? (size_t)(k0 + r) * limit + col0 + col : 0);
    cp_async16(dst + r * kLdT + col, p, valid);
  }
}

template <bool A_T, bool B_T>
__device__ __forceinline__ void load_stage(const GemmParams& p, bf16* a,
                                           bf16* b, int m0, int n0, int k0) {
  if (A_T)
    load_tile_t(a, p.A, m0, p.M, p.K, k0);
  else
    load_tile<kBM>(a, p.A, m0, p.M, p.K, k0);
  if (B_T)
    load_tile_t(b, p.B, n0, p.N, p.K, k0);
  else
    load_tile<kBN>(b, p.B, n0, p.N, p.K, k0);
}

template <int EPI, bool A_T, bool B_T>
__global__ void __launch_bounds__(kGemmThreads, 2)
    gemm_bf16_kernel(const GemmParams p) {
  extern __shared__ __align__(128) unsigned char gemm_smem[];
  bf16* As = reinterpret_cast<bf16*>(gemm_smem);  // [kStages][kTileElems]
  bf16* Bs = As + kStages * kTileElems;            // [kStages][kTileElems]

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

  const int ktiles = (p.K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles)
      load_stage<A_T, B_T>(p, As + s * kTileElems, Bs + s * kTileElems, m0,
                           n0, s * kBK);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();  // K step kt has landed (this thread's)
    __syncthreads();               // ... everyone's; stage kt-1 is free
    const int pre = kt + kStages - 1;
    if (pre < ktiles) {
      const int ps = pre % kStages;
      load_stage<A_T, B_T>(p, As + ps * kTileElems, Bs + ps * kTileElems, m0,
                           n0, pre * kBK);
    }
    cp_async_commit();  // possibly empty group: keeps the count uniform

    const bf16* a = As + (kt % kStages) * kTileElems;
    const bf16* b = Bs + (kt % kStages) * kTileElems;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t fa[kMT][4], fb[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int mrow = wm * kWarpM + i * 16;
        if (A_T)
          load_a_km(fa[i], a + kk * kLdT + mrow, kLdT, lane);
        else
          load_a_mk(fa[i], a + mrow * kLd + kk, kLd, lane);
      }
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j) {
        const int ncol = wn * kWarpN + j * 16;
        uint32_t r[4];
        if (B_T)
          load_b_kn(r, b + kk * kLdT + ncol, kLdT, lane);
        else
          load_b_nk(r, b + ncol * kLd + kk, kLd, lane);
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

  // Epilogue from registers: two adjacent columns per thread and row. N is
  // a multiple of 8, so a column pair is valid for every lane of the warp
  // or for none, and the shuffles below see the whole warp.
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int gn = n0 + wn * kWarpN + j * 8 + t * 2;
    if (gn >= p.N) continue;
    float2 bv = make_float2(0.0f, 0.0f);
    if (EPI == kBias || EPI == kBiasGelu || EPI == kBiasResidual ||
        EPI == kBiasGeluSave)
      bv = __bfloat1622float2(
          __ldg(reinterpret_cast<const __nv_bfloat162*>(p.bias + gn)));
    float csum0 = 0.0f, csum1 = 0.0f;  // kGeluBwd column sums
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int gm = m0 + wm * kWarpM + i * 16 + g + half * 8;
        if (gm >= p.M) continue;
        float v0 = acc[i][j][2 * half] + bv.x;
        float v1 = acc[i][j][2 * half + 1] + bv.y;
        const size_t off = (size_t)gm * p.N + gn;
        if (EPI == kF32) {
          *reinterpret_cast<float2*>(static_cast<float*>(p.C) + off) =
              make_float2(v0, v1);
          continue;
        }
        if (EPI == kGeluBwd) {
          const float2 hp = __bfloat1622float2(
              __ldg(reinterpret_cast<const __nv_bfloat162*>(p.aux_in + off)));
          v0 *= gelu_erf_grad(hp.x);
          v1 *= gelu_erf_grad(hp.y);
          csum0 += v0;  // db1 is summed from the fp32 dh_pre
          csum1 += v1;
          *reinterpret_cast<__nv_bfloat162*>(p.aux_out + off) =
              __floats2bfloat162_rn(gelu_erf(hp.x), gelu_erf(hp.y));
        }
        if (EPI == kBiasGeluSave)
          *reinterpret_cast<__nv_bfloat162*>(p.aux_out + off) =
              __floats2bfloat162_rn(v0, v1);
        if (EPI == kBiasGelu || EPI == kBiasGeluSave) {
          v0 = gelu_erf(v0);
          v1 = gelu_erf(v1);
        }
        if (EPI == kBiasResidual) {
          const float2 rv = __bfloat1622float2(
              __ldg(reinterpret_cast<const __nv_bfloat162*>(p.aux_in + off)));
          v0 += rv.x;
          v1 += rv.y;
        }
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.C) + off) =
            __floats2bfloat162_rn(v0, v1);
      }
    if (EPI == kGeluBwd) {
      // the 8 lanes of one column pair (g = 0..7) hold its 64 warp rows
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        csum0 += __shfl_xor_sync(0xffffffffu, csum0, o);
        csum1 += __shfl_xor_sync(0xffffffffu, csum1, o);
      }
      if (g == 0)
        *reinterpret_cast<float2*>(
            p.col_part + (size_t)(blockIdx.y * 2 + wm) * p.N + gn) =
            make_float2(csum0, csum1);
    }
  }
}

// C = epilogue(A · B (+ bias)) on `stream`; see the layouts at the top.
template <int EPI, bool A_T = false, bool B_T = false>
inline cudaError_t launch_gemm(const GemmParams& p, cudaStream_t stream) {
  if ((!A_T || !B_T) && p.K % kBK != 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_bf16_kernel<EPI, A_T, B_T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kGemmSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.N + kBN - 1) / kBN, (p.M + kBM - 1) / kBM);
  gemm_bf16_kernel<EPI, A_T, B_T>
      <<<grid, kGemmThreads, kGemmSmem, stream>>>(p);
  return cudaGetLastError();
}

// Rows of the column partial sums a kGeluBwd launch over M rows writes.
inline int gelu_bwd_part_rows(int M) { return 2 * ((M + kBM - 1) / kBM); }

}  // namespace vt
