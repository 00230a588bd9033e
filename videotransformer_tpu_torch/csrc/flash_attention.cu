// q-blocked flash attention, forward, for Hopper (sm_90a).
//
// Replaces videotransformer_tpu/kernels/flash_attention_pallas.py::_fwd_kernel
// (reached through _flash_fwd / flash_attention): per (b·h) slice,
//
//   s = (q kᵀ) · scale            fp32 accumulate from bf16 q, k
//   p = exp(s - max(s)) / sum     fp32, normalised before the product
//   o = bf16(bf16(p) · v)         fp32 accumulate
//
// with Nq != Nkv allowed (MViT's pooled keys and values). The TPU kernel
// kept the whole K and V of one slice in VMEM and the whole score row in
// registers; here K and V at Nkv = 1569 (602 KB at head dim 96) do not fit
// in the 227 KB of shared memory a block may use, so the keys are walked in
// 64-key tiles, twice:
//
//   pass 1: Q·Kᵀ per tile, the running row max m and row sum l (rescaled
//           when the max grows), as an online softmax does;
//   pass 2: Q·Kᵀ again, p = exp(s - m) / l exactly as the TPU kernel forms
//           it, rounded to bf16 and multiplied into V.
//
// The second product of QKᵀ costs half as much again as the attention's
// 4·Nq·Nkv·hd FLOPs, and buys the TPU kernel's rounding: p is normalised in
// fp32 before it is rounded, where an online softmax rounds unnormalised
// probabilities against a running max. No rescaled output accumulator is
// kept either. Beyond the TPU kernel's output, the row log-sum-exp
// lse = m + log(l) is written in fp32, so the backward recomputes p from
// (q, k, lse) with no max pass (a residual the TPU kernel did not keep).
//
// Layout: one block per (64-query tile, b·h); 4 warps of 16 query rows. The
// query tile stays in shared memory; K (and V in pass 2) tiles are
// double-buffered there with cp.async, so the next tile loads while the
// tensor cores (mma.sync m16n8k16) work on this one. Padded keys
// (past Nkv) score -inf and read zero V rows; padded query rows compute on
// zeros and are not stored.
//
// Bound: 4·Nq·Nkv·hd FLOPs against (2·Nq + 2·Nkv)·hd·2 bytes; at the MViT
// shapes (Nkv 393/1569, hd 96) the arithmetic intensity is in the hundreds
// to thousands of FLOPs a byte, so the tensor cores bound it. mma.sync
// reaches part of Hopper's rate; wgmma/TMA and a single pass are later work.

#include "flash_common.cuh"

namespace vt {

template <int HD>
__host__ __device__ constexpr size_t flash_fwd_smem() {
  return (size_t)5 * FlashTile<HD>::kElems * sizeof(bf16);  // Q, 2 K, 2 V
}

template <int HD>
__global__ void __launch_bounds__(kFlashThreads)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int Nq, int Nkv, float scale) {
  using T = FlashTile<HD>;
  constexpr int LD = T::kLd;
  extern __shared__ __align__(128) unsigned char flash_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(flash_smem);
  bf16* Ks = Qs + T::kElems;      // [2][tile]
  bf16* Vs = Ks + 2 * T::kElems;  // [2][tile]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kFlashRows;
  const bf16* qb = q + (size_t)bh * Nq * HD;
  const bf16* kb = k + (size_t)bh * Nkv * HD;
  const bf16* vb = v + (size_t)bh * Nkv * HD;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int nkt = (Nkv + kFlashRows - 1) / kFlashRows;
  const int steps = 2 * nkt;  // pass 1 then pass 2

  // step j loads K tile j % nkt, and V as well in pass 2
  auto issue = [&](int j) {
    const int buf = j & 1;
    const int kt = j < nkt ? j : j - nkt;
    load_flash_tile<HD>(Ks + buf * T::kElems, kb, kt * kFlashRows, Nkv);
    if (j >= nkt)
      load_flash_tile<HD>(Vs + buf * T::kElems, vb, kt * kFlashRows, Nkv);
  };

  load_flash_tile<HD>(Qs, qb, q0, Nq);
  issue(0);
  cp_async_commit();

  float m[2] = {neg_inf(), neg_inf()};  // rows g and g + 8
  float l[2] = {0.0f, 0.0f};            // this thread's columns only
  float acc[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.0f;

  for (int j = 0; j < steps; ++j) {
    if (j + 1 < steps) issue(j + 1);
    cp_async_commit();
    cp_async_wait<1>();  // step j (and the Q tile) have landed
    __syncthreads();
    const bool second = j >= nkt;
    const int kt = second ? j - nkt : j;

    float s[8][4];
    tile_product_nt<HD>(s, Qs + warp * 16 * LD, Ks + (j & 1) * T::kElems,
                        lane);
    // scale, and -inf past Nkv
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kt * kFlashRows + n * 8 + t * 2 + (e & 1);
        s[n][e] = col < Nkv ? s[n][e] * scale : neg_inf();
      }

    if (!second) {
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // a quad shares a row
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        l[i] *= expf(m[i] - mx[i]);  // 0 while m is -inf (l is 0 then)
        m[i] = mx[i];
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) l[e >> 1] += expf(s[n][e] - m[e >> 1]);
      if (j == nkt - 1) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
          l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = expf(s[n][e] - m[e >> 1]) / l[e >> 1];  // 0 past Nkv
      tile_product_acc<HD>(acc, s, Vs + (j & 1) * T::kElems, lane);
    }
    __syncthreads();  // buffer j & 1 is refilled by step j + 2
  }

  const int g = lane >> 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + i * 8;
    if (row >= Nq) continue;
    bf16* dst = o + ((size_t)bh * Nq + row) * HD + t * 2;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      *reinterpret_cast<__nv_bfloat162*>(dst + d * 8) =
          __floats2bfloat162_rn(acc[d][2 * i], acc[d][2 * i + 1]);
    if (t == 0) lse[(size_t)bh * Nq + row] = m[i] + logf(l[i]);
  }
}

template <int HD>
cudaError_t launch_flash_fwd(const bf16* q, const bf16* k, const bf16* v,
                             bf16* o, float* lse, int BH, int Nq, int Nkv,
                             float scale, cudaStream_t st) {
  constexpr size_t smem = flash_fwd_smem<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Nq + kFlashRows - 1) / kFlashRows, BH);
  flash_fwd_kernel<HD><<<grid, kFlashThreads, smem, st>>>(q, k, v, o, lse, Nq,
                                                          Nkv, scale);
  return cudaGetLastError();
}

}  // namespace vt

extern "C" {

// q (BH, Nq, hd), k and v (BH, Nkv, hd), bf16; o (BH, Nq, hd) bf16 and lse
// (BH, Nq) fp32 are written. hd is 32, 64, 96 or 128.
int vt_flash_attention_fwd(const void* q, const void* k, const void* v,
                           void* o, void* lse, int BH, int Nq, int Nkv,
                           int hd, float scale, void* stream) {
  using vt::bf16;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(o);
  float* lb = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH < 1 || Nq < 1 || Nkv < 1) return cudaErrorInvalidValue;
  switch (hd) {
    case 32: return vt::launch_flash_fwd<32>(qb, kb, vb, ob, lb, BH, Nq, Nkv, scale, st);
    case 64: return vt::launch_flash_fwd<64>(qb, kb, vb, ob, lb, BH, Nq, Nkv, scale, st);
    case 96: return vt::launch_flash_fwd<96>(qb, kb, vb, ob, lb, BH, Nq, Nkv, scale, st);
    case 128: return vt::launch_flash_fwd<128>(qb, kb, vb, ob, lb, BH, Nq, Nkv, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
