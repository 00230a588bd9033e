// Flash attention, forward, for Hopper (sm_90a): wgmma products, TMA loads,
// one pass over the keys.
//
// Replaces videotransformer_tpu/kernels/flash_attention_pallas.py::_fwd_kernel
// (reached through _flash_fwd / flash_attention): per (b·h) slice,
//
//   o = softmax(q kᵀ · scale) v       bf16 q, k, v; fp32 sums; bf16 o
//
// with Nq != Nkv allowed (MViT's pooled keys and values), and beyond the TPU
// kernel's output the row log-sum-exp lse = m + log(l) in fp32, from which
// the backward recomputes p with no max pass.
//
// Bound: 4·Nq·Nkv·hd FLOPs against (2·Nq + 2·Nkv)·hd·2 bytes; at the MViT
// shapes (Nkv 393 or 1569, hd 96) hundreds to thousands of FLOPs a byte, so
// the tensor cores bound it, and after them the exponentials: one score
// carries 4·hd tensor-core FLOPs and one ex2, and at hd 96 the special
// function units take about two thirds of the tensor cores' time for it.
// What the design does about that:
//
// - One pass over the keys with an online softmax: a running row max m and
//   sum l (fp32), an fp32 output accumulator in registers rescaled by
//   2^(m_old - m_new) when the max grows, and 1/l applied once, in the
//   epilogue. A score costs one FFMA and one ex2: p̃ = 2^(s·scale·log2e - m)
//   with m kept in that base-2 scale.
// - Products by wgmma: each consumer warpgroup owns 64 query rows, S = Q·Kᵀ
//   is m64n80k16 with Q and K from shared memory (K-major), O += P̃·V takes
//   P̃ from registers (the accumulator's layout is the A-fragment layout) and
//   V from shared memory MN-major, since V lies [key][hd].
// - Loads by TMA: one producer thread (its warpgroup gives up registers
//   with setmaxnreg) loads the block's 128 query rows once and streams
//   80-key K and V tiles through a three-stage ring of mbarriers; each stage
//   is released by the eight consumer warps once their products have read
//   it. The maps are 3-D over (B·H, N, hd), so a tile past a slice's N reads
//   zeros, never the next slice; those keys are set to -inf before the max.
// - The exponentials overlap the products twice over. Inside a warpgroup, S
//   of tile j is issued together with P̃·V of tile j - 1, and the softmax of
//   tile j runs while the tensor cores work on P̃·V (intra-warpgroup
//   pipelining). Between the two warpgroups, named barriers hand the tensor
//   cores back and forth (ping-pong: one issues its products while the
//   other runs its softmax). 80-key tiles leave 2% of the products on
//   padding at Nkv = 393 and 1569; a block whose second warpgroup's rows
//   are all past Nq lets it idle.
//
// Numerics: p̃ = exp(s - m_running) is rounded to bf16 before the P̃·V
// product, where the TPU kernel rounds the normalised p; the function and the
// products are the same, the rounding point moves (kernels/flash_attention.py
// states by how much).

#include "flash_common.cuh"

namespace vt {

template <int HD>
struct FwdCfg {
  static constexpr int kBN = kFlashBN;
  static constexpr int kStages = kFlashStages;
  static constexpr uint32_t kQBytes = kFlashBM * HD * 2;
  static constexpr uint32_t kKVBytes = kBN * HD * 2;  // one K or V tile
  static constexpr size_t kSmem =  // Q, the ring, the barriers
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * (1 + 3 * kStages);
};

// One consumer warpgroup's state: 64 query rows, this thread's rows lane/4
// and lane/4 + 8 of its warp's 16.
template <int HD>
struct FwdRows {
  static constexpr int kBN = kFlashBN;
  float s[kBN / 2];      // scores, then p̃ in fp32
  uint32_t p[kBN / 4];   // p̃ in bf16: the A fragments of P̃·V
  float o[HD / 2];       // output accumulator
  float m[2], l[2];      // running max (base-2 scaled) and this thread's sum
};

template <int HD>
__device__ __forceinline__ void issue_scores(FwdRows<HD>& r, const bf16* Qs,
                                             const bf16* Kt, int row0) {
  sm90::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
    sm90::Wgmma<kFlashBN, 0>::ss(r.s, desc_kmajor<HD, kFlashBM>(Qs, row0, ks),
                                 desc_kmajor<HD, kFlashBN>(Kt, 0, ks), ks > 0);
  sm90::wgmma_commit();
}

template <int HD>
__device__ __forceinline__ void issue_pv(FwdRows<HD>& r, const bf16* Vt) {
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kFlashBN / 16; ++kk)
    sm90::Wgmma<HD, 1>::rs(r.o, r.p + 4 * kk, desc_mnmajor<HD, kFlashBN>(Vt, kk),
                           1);
  sm90::wgmma_commit();
}

// Online softmax of one score tile in place (s -> p̃, fp32); keys at or past
// `valid` score -inf. Returns the rescale factors of the rows in alpha.
template <int HD>
__device__ __forceinline__ void softmax_tile(FwdRows<HD>& r, float (&alpha)[2],
                                             int valid, float sl2, int t) {
  constexpr int R = kFlashBN / 2;
  if (valid < kFlashBN) {
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (acc_col(i, t) >= valid) r.s[i] = neg_inf();
  }
  float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
  for (int i = 0; i < R; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], r.s[i]);
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // a quad shares a row
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(r.m[h], mx[h] * sl2);  // scale > 0
    alpha[h] = ex2(r.m[h] - m_new);                 // 0 while m is -inf
    r.m[h] = m_new;
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int h = (i >> 1) & 1;
    r.s[i] = ex2(fmaf(r.s[i], sl2, -r.m[h]));
    sum[h] += r.s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) r.l[h] = r.l[h] * alpha[h] + sum[h];
}

template <int HD>
__device__ __forceinline__ void rescale_and_pack(FwdRows<HD>& r,
                                                 const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) r.o[i] *= alpha[(i >> 1) & 1];
  acc_to_a<kFlashBN / 2>(r.p, r.s);
}

template <int HD>
__global__ void __launch_bounds__(kFlashThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     bf16* __restrict__ o, float* __restrict__ lse, int Nq,
                     int Nkv, float scale) {
  using C = FwdCfg<HD>;
  constexpr int BN = C::kBN, ST = C::kStages;
  extern __shared__ unsigned char flash_smem[];
  unsigned char* base = flash_smem_base(flash_smem);
  bf16* Qs = reinterpret_cast<bf16*>(base);
  bf16* Ks = reinterpret_cast<bf16*>(base + C::kQBytes);  // [ST][BN x HD]
  bf16* Vs = Ks + ST * BN * HD;                            // [ST][BN x HD]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + ST * BN * HD);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + ST;
  uint64_t* empty = v_full + ST;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kFlashBM;
  const int nkt = (Nkv + BN - 1) / BN;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      sm90::mbar_init(k_full + s, 1);
      sm90::mbar_init(v_full + s, 1);
      sm90::mbar_init(empty + s, 8);  // the consumers' eight warps
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    sm90::regs_dec<kFlashProducerRegs>();
    if (threadIdx.x == 256) {
      sm90::mbar_expect_tx(q_full, C::kQBytes);
      tma_tile<HD, kFlashBM>(Qs, &q_map, q_full, q0, bh);
      for (int j = 0; j < nkt; ++j) {
        const int s = j % ST;
        if (j >= ST) sm90::mbar_wait(empty + s, (j / ST - 1) & 1);
        sm90::mbar_expect_tx(k_full + s, C::kKVBytes);
        tma_tile<HD, BN>(Ks + s * BN * HD, &k_map, k_full + s, j * BN, bh);
        sm90::mbar_expect_tx(v_full + s, C::kKVBytes);
        tma_tile<HD, BN>(Vs + s * BN * HD, &v_map, v_full + s, j * BN, bh);
      }
    }
    return;
  }

  sm90::regs_inc<kFlashConsumerRegs>();
  const int row0 = wg * 64;  // this warpgroup's rows of the block
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % 128) / 32;
  const int t = lane & 3;
  if (q0 + row0 >= Nq) {  // all padding: release the stages, compute nothing
    for (int j = 0; j < nkt; ++j) {
      sm90::mbar_wait(k_full + j % ST, (j / ST) & 1);
      sm90::mbar_wait(v_full + j % ST, (j / ST) & 1);
      if (lane == 0) sm90::mbar_arrive(empty + j % ST);
    }
    return;
  }

  const float sl2 = scale * kLog2e;
  TensorTurns turns(wg, q0 + 64 < Nq);
  FwdRows<HD> r;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) r.o[i] = 0.0f;
  r.m[0] = r.m[1] = neg_inf();
  r.l[0] = r.l[1] = 0.0f;
  float alpha[2];

  sm90::mbar_wait(q_full, 0);
  sm90::mbar_wait(k_full, 0);
  turns.wait();
  issue_scores<HD>(r, Qs, Ks, row0);
  turns.pass(false);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(r.s);
  softmax_tile<HD>(r, alpha, Nkv, sl2, t);
  rescale_and_pack<HD>(r, alpha);

  for (int j = 1; j < nkt; ++j) {
    const int sj = j % ST, sp = (j - 1) % ST;
    sm90::mbar_wait(k_full + sj, (j / ST) & 1);
    sm90::mbar_wait(v_full + sp, ((j - 1) / ST) & 1);
    turns.wait();
    issue_scores<HD>(r, Qs, Ks + sj * BN * HD, row0);
    issue_pv<HD>(r, Vs + sp * BN * HD);
    turns.pass(false);
    sm90::wgmma_wait<1>();  // the scores of tile j; P̃·V of j - 1 runs on
    sm90::fence_regs(r.s);
    softmax_tile<HD>(r, alpha, Nkv - j * BN, sl2, t);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(r.o);
    sm90::fence_regs(r.s);
    if (lane == 0) sm90::mbar_arrive(empty + sp);
    rescale_and_pack<HD>(r, alpha);
  }
  const int sl = (nkt - 1) % ST;
  sm90::mbar_wait(v_full + sl, ((nkt - 1) / ST) & 1);
  turns.wait();
  issue_pv<HD>(r, Vs + sl * BN * HD);
  turns.pass(true);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(r.o);

  const int g = lane >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    r.l[h] += __shfl_xor_sync(0xffffffffu, r.l[h], 1);
    r.l[h] += __shfl_xor_sync(0xffffffffu, r.l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + row0 + warp * 16 + g + h * 8;
    if (row >= Nq) continue;
    const float inv = 1.0f / r.l[h];
    bf16* dst = o + ((size_t)bh * Nq + row) * HD + 2 * t;
#pragma unroll
    for (int jn = 0; jn < HD / 8; ++jn)
      *reinterpret_cast<__nv_bfloat162*>(dst + jn * 8) = __floats2bfloat162_rn(
          r.o[4 * jn + 2 * h] * inv, r.o[4 * jn + 2 * h + 1] * inv);
    if (t == 0) lse[(size_t)bh * Nq + row] = (r.m[h] + log2f(r.l[h])) * kLn2;
  }
}

template <int HD>
cudaError_t launch_flash_fwd(const bf16* q, const bf16* k, const bf16* v,
                             bf16* o, float* lse, int BH, int Nq, int Nkv,
                             float scale, cudaStream_t st) {
  CUtensorMap qm, km, vm;
  if (!flash_map<HD>(&qm, q, BH, Nq, kFlashBM) ||
      !flash_map<HD>(&km, k, BH, Nkv, kFlashBN) ||
      !flash_map<HD>(&vm, v, BH, Nkv, kFlashBN))
    return cudaErrorInvalidValue;
  constexpr size_t smem = FwdCfg<HD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Nq + kFlashBM - 1) / kFlashBM, BH);
  flash_fwd_kernel<HD><<<grid, kFlashThreads, smem, st>>>(qm, km, vm, o, lse,
                                                          Nq, Nkv, scale);
  return cudaGetLastError();
}

}  // namespace vt

extern "C" {

// q (BH, Nq, hd), k and v (BH, Nkv, hd), bf16, 16-byte aligned; o (BH, Nq,
// hd) bf16 and lse (BH, Nq) fp32 are written. hd is 32, 64, 96 or 128;
// scale > 0.
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
  if (BH < 1 || Nq < 1 || Nkv < 1 || !(scale > 0.0f))
    return cudaErrorInvalidValue;
  switch (hd) {
    case 32: return vt::launch_flash_fwd<32>(qb, kb, vb, ob, lb, BH, Nq, Nkv, scale, st);
    case 64: return vt::launch_flash_fwd<64>(qb, kb, vb, ob, lb, BH, Nq, Nkv, scale, st);
    case 96: return vt::launch_flash_fwd<96>(qb, kb, vb, ob, lb, BH, Nq, Nkv, scale, st);
    case 128: return vt::launch_flash_fwd<128>(qb, kb, vb, ob, lb, BH, Nq, Nkv, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
