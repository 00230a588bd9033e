// Flash attention, forward, for Hopper (sm_90a): wgmma products, TMA loads,
// one pass over the keys. The kernel of flash_attention.cu (B5) and of the
// fused MHSA's long attention (fused_mhsa.cu, B1 at L > 256).
//
// Replaces videotransformer_tpu/kernels/flash_attention_pallas.py::_fwd_kernel
// (reached through _flash_fwd / flash_attention): per (b·h) slice,
//
//   o = softmax(q kᵀ · scale) v       bf16 q, k, v; fp32 sums; bf16 o
//
// with Nq != Nkv allowed (MViT's pooled keys and values; slices laid out as
// a HeadLayout says, flash_common.cuh), and beyond the TPU
// kernel's output the row log-sum-exp lse = m + log(l) in fp32, from which
// the backward recomputes p with no max pass.
//
// Bound: 4·Nq·Nkv·hd FLOPs against (2·Nq + 2·Nkv)·hd·2 bytes; at the main
// shapes (MViT: Nkv 393 or 1569, hd 96; joint space-time and the 448²
// spatial rows: N 785 to 3137, hd 64) hundreds to thousands of FLOPs a byte,
// so the tensor cores bound it, and beside them the exponentials: one score
// carries 4·hd tensor-core FLOPs and one ex2, and an SM issues ~4096 dense
// bf16 FLOPs but 16 ex2 a clock. At hd 96 the special function units take
// about two thirds of the tensor cores' time; at hd 64 as long as the
// tensor cores. What the design does about that:
//
// - One pass over the keys with an online softmax: a running row max m and
//   sum l (fp32), an fp32 output accumulator in registers rescaled by
//   2^(m_old - m_new) when the max grows, and 1/l applied once, in the
//   epilogue. A score costs one FMNMX, one FFMA, one ex2 and one FADD:
//   p̃ = 2^(s·scale·log2e - m) with m kept in that base-2 scale; keys past
//   Nkv are set to -inf in the last tile only.
// - Products by wgmma: each consumer warpgroup owns 64 query rows, S = Q·Kᵀ
//   is m64nBNk16 with Q and K from shared memory (K-major), O += P̃·V takes
//   P̃ from registers (the accumulator's layout is the A-fragment layout) and
//   V from shared memory MN-major, since V lies [key][hd].
// - Loads by TMA: one producer thread (its warpgroup gives up registers
//   with setmaxnreg) loads the block's query rows once and streams BN-key K
//   and V tiles through a ring of mbarriers; each stage is released by the
//   consumer warps once their products have read it. The maps are 3-D over
//   (B·H, N, hd), so a tile past a slice's N reads zeros, never the next
//   slice.
// - The exponentials overlap the products twice over. Inside a warpgroup, S
//   of tile j is issued together with P̃·V of tile j - 1, and the softmax of
//   tile j runs while the tensor cores work on P̃·V (intra-warpgroup
//   pipelining). Between the warpgroups, named barriers hand the tensor
//   cores round (one issues its products while the others run their
//   softmax). A block whose last warpgroups' rows are all past Nq lets
//   them idle.
//
// Tiles per head dim (FwdCfg). hd 32, 96 and 128 keep the MViT design: 128
// queries a block (two consumer warpgroups at 240 registers), 80-key tiles
// (2% of the products on padding at Nkv = 393 and 1569), a three-stage
// ring. hd 64 (joint space-time and the 448² spatial rows, N = 1 + 196k:
// 785, 1569, 3137) has its own: three consumer warpgroups (192 queries a
// block) at 160 registers each, 96-key tiles, a three-stage ring (98 KB),
// and each warpgroup's Q rows held as wgmma A fragments in registers,
// loaded once (load_a_frags). At hd 64 a warpgroup's softmax of a tile
// takes as long as its products, so with two warpgroups the tensor cores
// wait whenever one softmax runs late; a third keeps two tiles' products
// queued behind the one being exponentiated. S = Q·Kᵀ with both operands
// in shared memory reads 5 KB a 48-cycle k-step at 96 keys, 84% of the
// SM's 128 bytes a clock; with Q in registers it reads K alone. Tried on
// an H100 and left out (tools/flash_bench.py --variant, PERF.md §6): two
// warpgroups, 128-key tiles in two stages, and a quarter of the ex2 moved
// to the FMA pipe (a polynomial on the bits of x + 1.5·2^23: it took more
// issue slots than it freed at the special function units). A score costs
// what it did in the MViT design: one ex2, ~1.4 FFMA, ~1.1 FMNMX, ~1.2 FADD
// and 0.67 F2FP in the machine code (flash_bench --sass); the time came
// from keeping the tensor cores fed.
//
// Numerics: p̃ = exp(s - m_running) is rounded to bf16 before the P̃·V
// product, where the TPU kernel rounds the normalised p; the function and the
// products are the same, the rounding point moves (kernels/flash_attention.py
// states by how much).

#pragma once

#include "flash_common.cuh"

namespace vt {

template <int HD>
struct FwdCfg {
  static constexpr int kWG = 2;        // consumer warpgroups
  static constexpr int kBN = kFlashBN;  // keys a tile
  static constexpr int kStages = kFlashStages;
  static constexpr int kConsumerRegs = kFlashConsumerRegs;
  static constexpr int kProducerRegs = kFlashProducerRegs;
  static constexpr bool kRegA = false;  // Q as register fragments
  static constexpr int kBM = 64 * kWG;
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr uint32_t kQBytes = kBM * HD * 2;
  static constexpr uint32_t kKVBytes = kBN * HD * 2;  // one K or V tile
  static constexpr size_t kSmem =  // Q, the ring, the barriers
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * (1 + 3 * kStages);
};

template <>
struct FwdCfg<64> {
  static constexpr int kWG = 3;
  static constexpr int kBN = 96;
  static constexpr int kStages = 3;
  static constexpr int kConsumerRegs = 160;
  static constexpr int kProducerRegs = 24;
  static constexpr bool kRegA = true;
  static constexpr int kBM = 64 * kWG;
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr uint32_t kQBytes = kBM * 64 * 2;
  static constexpr uint32_t kKVBytes = kBN * 64 * 2;
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * (1 + 3 * kStages);
};

// One consumer warpgroup's state: 64 query rows, this thread's rows lane/4
// and lane/4 + 8 of its warp's 16.
template <int HD>
struct FwdRows {
  static constexpr int kBN = FwdCfg<HD>::kBN;
  float s[kBN / 2];      // scores, then p̃ in fp32
  uint32_t p[kBN / 4];   // p̃ in bf16: the A fragments of P̃·V
  float o[HD / 2];       // output accumulator
  float m[2], l[2];      // running max (base-2 scaled) and this thread's sum
  uint32_t qa[16];       // Q rows as A fragments (FwdCfg::kRegA)
};

template <int HD>
__device__ __forceinline__ void issue_scores(FwdRows<HD>& r, const bf16* Qs,
                                             const bf16* Kt, int row0) {
  using C = FwdCfg<HD>;
  sm90::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    if constexpr (C::kRegA)
      sm90::Wgmma<C::kBN, 0>::rs(r.s, r.qa + 4 * ks,
                                 desc_kmajor<HD, C::kBN>(Kt, 0, ks), ks > 0);
    else
      sm90::Wgmma<C::kBN, 0>::ss(r.s, desc_kmajor<HD, C::kBM>(Qs, row0, ks),
                                 desc_kmajor<HD, C::kBN>(Kt, 0, ks), ks > 0);
  }
  sm90::wgmma_commit();
}

template <int HD>
__device__ __forceinline__ void issue_pv(FwdRows<HD>& r, const bf16* Vt) {
  constexpr int BN = FwdCfg<HD>::kBN;
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    sm90::Wgmma<HD, 1>::rs(r.o, r.p + 4 * kk, desc_mnmajor<HD, BN>(Vt, kk), 1);
  sm90::wgmma_commit();
}

// Online softmax of one score tile in place (s -> p̃, fp32); in the last
// tile (`valid` < BN) keys at or past `valid` score -inf. Returns the
// rescale factors of the rows in alpha.
template <int HD>
__device__ __forceinline__ void softmax_tile(FwdRows<HD>& r, float (&alpha)[2],
                                             int valid, float sl2, int t) {
  using C = FwdCfg<HD>;
  constexpr int R = C::kBN / 2;
  if (valid < C::kBN) {
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
  acc_to_a<FwdCfg<HD>::kBN / 2>(r.p, r.s);
}

template <int HD>
__global__ void __launch_bounds__(FwdCfg<HD>::kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     bf16* __restrict__ o, float* __restrict__ lse, int Nq,
                     int Nkv, float scale, HeadLayout lay) {
  using C = FwdCfg<HD>;
  constexpr int BN = C::kBN, ST = C::kStages, NWG = C::kWG;
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
  const int z = lay.seq(bh), hc = lay.head_col(bh, HD);
  const int q0 = blockIdx.x * C::kBM;
  const int nkt = (Nkv + BN - 1) / BN;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      sm90::mbar_init(k_full + s, 1);
      sm90::mbar_init(v_full + s, 1);
      sm90::mbar_init(empty + s, 4 * NWG);  // the consumers' warps
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == NWG) {  // producer
    sm90::regs_dec<C::kProducerRegs>();
    if (threadIdx.x == 128 * NWG) {
      sm90::mbar_expect_tx(q_full, C::kQBytes);
      tma_tile<HD, C::kBM>(Qs, &q_map, q_full, lay.q_col + hc, q0, z);
      for (int j = 0; j < nkt; ++j) {
        const int s = j % ST;
        if (j >= ST) sm90::mbar_wait(empty + s, (j / ST - 1) & 1);
        sm90::mbar_expect_tx(k_full + s, C::kKVBytes);
        tma_tile<HD, BN>(Ks + s * BN * HD, &k_map, k_full + s, lay.k_col + hc,
                         j * BN, z);
        sm90::mbar_expect_tx(v_full + s, C::kKVBytes);
        tma_tile<HD, BN>(Vs + s * BN * HD, &v_map, v_full + s, lay.v_col + hc,
                         j * BN, z);
      }
    }
    return;
  }

  sm90::regs_inc<C::kConsumerRegs>();
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
  const int active = min(NWG, (Nq - q0 + 63) / 64);
  TensorTurns turns(wg, active);
  FwdRows<HD> r;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) r.o[i] = 0.0f;
  r.m[0] = r.m[1] = neg_inf();
  r.l[0] = r.l[1] = 0.0f;
  float alpha[2];

  sm90::mbar_wait(q_full, 0);
  if constexpr (C::kRegA) load_a_frags(r.qa, Qs, row0 + warp * 16, lane);
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
    bf16* dst = o + lay.out_row(bh, Nq, row, lay.q_ld, HD) + 2 * t;
#pragma unroll
    for (int jn = 0; jn < HD / 8; ++jn)
      *reinterpret_cast<__nv_bfloat162*>(dst + jn * 8) = __floats2bfloat162_rn(
          r.o[4 * jn + 2 * h] * inv, r.o[4 * jn + 2 * h + 1] * inv);
    if (t == 0) lse[(size_t)bh * Nq + row] = (r.m[h] + log2f(r.l[h])) * kLn2;
  }
}

// The forward over BH slices laid out as `lay` says, through maps of
// FwdCfg<HD>::kBM-row (q) and kBN-row (k, v) boxes of HD / PW panels.
template <int HD>
cudaError_t launch_flash_fwd(const CUtensorMap& qm, const CUtensorMap& km,
                             const CUtensorMap& vm, bf16* o, float* lse,
                             int BH, int Nq, int Nkv, float scale,
                             const HeadLayout& lay, cudaStream_t st) {
  using C = FwdCfg<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((Nq + C::kBM - 1) / C::kBM, BH);
  flash_fwd_kernel<HD><<<grid, C::kThreads, C::kSmem, st>>>(
      qm, km, vm, o, lse, Nq, Nkv, scale, lay);
  return cudaGetLastError();
}

}  // namespace vt
