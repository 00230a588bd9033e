// Flash attention, backward, for Hopper (sm_90a): wgmma products, TMA loads.
// The kernels of flash_attention_bwd.cu (B6) and of the fused MHSA's long
// attention backward (fused_mhsa_bwd.cu, B3 at L > 256).
//
// Replaces videotransformer_tpu/kernels/flash_attention_pallas.py::_bwd_kernel
// (reached through _flash_bwd / the custom_vjp of flash_attention). From q,
// k, v, the forward's output o and row log-sum-exp lse, and the output
// gradient do, all per (b·h) slice:
//
//   p     = exp(q kᵀ · scale - lse)                     fp32
//   delta = rowsum(do · o)                              fp32
//   dp    = do vᵀ                                       fp32
//   ds    = p · (dp - delta) · scale                    fp32
//   dv    = bf16(p)ᵀ do,  dq = bf16(ds) k,  dk = bf16(ds)ᵀ q   fp32 sums
//
// Slices are read and written where a HeadLayout (flash_common.cuh) puts
// them. dq comes back in q's dtype; dk and dv are summed in fp32 and
// returned in k's dtype, the TPU kernel's contract. The TPU kernel took
// delta as
// rowsum(dp · p) over the whole key row it held; here a key row is walked in
// tiles, so delta is rowsum(do · o) = rowsum(dp · p) (o = p v), from the
// saved bf16 o. The plain version (kernels/flash_attention.py) follows this
// order.
//
// Bound: 10·Nq·Nkv·hd FLOPs for the five products against
// (4·Nq + 6·Nkv)·hd·2 bytes: the tensor cores bound it at the main shapes
// (MViT's at hd 96; joint space-time and the 448² rows at hd 64), then the
// exponentials (one ex2 a score in each of the two passes below; at hd 64
// an ex2 takes as long at the special function units as 2·hd FLOPs do at
// the tensor cores, where a pass issues 6·hd or 8·hd a score).
// The TPU grid ran its query blocks in order and added dk/dv into resident
// fp32 blocks; on the card blocks run in no order, and every sum here keeps
// a fixed order (no atomics: two runs give the same bits). Two passes:
//
//   1. dq: as the forward, a block of 128 queries (two consumer warpgroups
//      of 64, one producer thread streaming K and V tiles through a
//      three-stage TMA ring; 80 keys a tile, 96 at hd 64: DqCfg): S = Q·Kᵀ
//      and dP = dO·Vᵀ by wgmma from shared memory, dS in registers as the A
//      operand of dQ += dS·K (K read MN-major from the same tile). The
//      products of key tile j are issued with dQ of tile j - 1, so the
//      exponentials of one run under the other, and the two warpgroups take
//      turns at the tensor cores. The
//      block also loads its O tile, and under its first products forms
//      delta = rowsum(dO · O) and lse·log2e for its rows, which it writes
//      to row arrays padded to a multiple of 128 rows (padding: delta 0,
//      lse +inf, so a padded query gives p = 0) for the second pass: no
//      separate pass reads O and dO again.
//   2. dk, dv: a block of 64 keys (one consumer warpgroup, two blocks a SM)
//      keeps its K and V in shared memory and streams 64-query tiles of Q,
//      dO, lse and delta through a two-stage ring: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ
//      from shared memory, then Pᵀ and dSᵀ from registers into
//      dV += Pᵀ·dO and dK += dSᵀ·Q, with dO and Q read MN-major. Where the
//      grid is short of two blocks a SM (MViT's first block: B·H = 8, seven
//      key tiles a slice), the query range is split, the fp32 partials are
//      written out and a last kernel sums them in split order; with one
//      split the pass writes bf16 itself.
//
// The two passes each compute Q·Kᵀ and dO·Vᵀ, 14·Nq·Nkv·hd FLOPs issued
// against 10: fusing them needs dq summed across key blocks, which without
// atomics means fp32 dq partials per key tile, more traffic at the MViT
// shapes than the products they save. At hd 64 a one-pass design was built
// and measured on an H100 (128-key blocks walking every 64-query tile, dS
// through shared memory into dQ = dS·K, each dq tile added into an fp32
// accumulator by a 16 KB bulk reduction, key blocks admitted in a fixed
// order by a counter per tile): 5 products and one ex2 a score, but
// Nkv / 128 reductions of every dq row, 1.9 GB of L2 reductions a call at
// (96, 3137, 3137). It ran slower than these two passes at every hd-64
// shape, and the reductions alone (ordered or not) cost more than the
// recomputed products: two passes stay, with hd-64 tiles of their own.
//
// Tiles per head dim. hd 32, 96 and 128 keep the MViT design above. hd 64
// has its own: the dq pass at 96-key tiles (3137 keys: 33 tiles, 1%
// padding), and the dk/dv pass holding each warp's K and V rows as wgmma
// A fragments in registers, loaded once (load_a_frags): Sᵀ = K·Qᵀ and
// dPᵀ = V·dOᵀ at n = 64 with both operands in shared memory read the SM's
// whole 128 bytes a clock, with K and V in registers half of it. Tried on
// an H100 and left out (tools/flash_bench.py --variant, PERF.md §6): the
// dq pass at 80-key tiles, or with Q and dO in registers; the dk/dv pass
// with two warpgroups of 64 keys a block (with and without turns at the
// tensor cores), with three at 32-query tiles, with a tile's Sᵀ and dPᵀ
// issued beside the previous tile's dV and dK, and with three or four
// stages.

#pragma once

#include "flash_common.cuh"

namespace vt {

constexpr int kBwdBlocksTarget = 2 * 132;  // dk/dv blocks: two a SM

// Rows a slice of the row arrays (lse·log2e, delta) takes: the dq pass's
// blocks cover them exactly, the dk/dv pass's query tiles fall inside.
static_assert(kFlashBM % kFlashBQ == 0, "query tiles");
__host__ __device__ inline int padded_rows(int Nq) {
  return (Nq + kFlashBM - 1) / kFlashBM * kFlashBM;
}

// Query tiles each split of the dk/dv pass walks, and the number of splits.
__host__ __device__ inline int bwd_tiles_per_split(int BH, int Nq, int Nkv) {
  const int nqt = (Nq + kFlashBQ - 1) / kFlashBQ;
  const int nkt = (Nkv + 63) / 64;
  int want = kBwdBlocksTarget / (nkt * BH);
  want = want < 1 ? 1 : (want > nqt ? nqt : want);
  return (nqt + want - 1) / want;
}

__host__ __device__ inline int bwd_splits(int BH, int Nq, int Nkv) {
  const int nqt = (Nq + kFlashBQ - 1) / kFlashBQ;
  const int per = bwd_tiles_per_split(BH, Nq, Nkv);
  return (nqt + per - 1) / per;
}

// ---- 1. dq, delta and lse·log2e ---------------------------------------------

template <int HD>
struct DqCfg {
  static constexpr int kBN = HD == 64 ? 96 : kFlashBN;  // keys a tile
  static constexpr int kStages = kFlashStages;
  static constexpr uint32_t kQBytes = kFlashBM * HD * 2;  // Q, dO, O alike
  static constexpr uint32_t kKVBytes = kBN * HD * 2;
  static constexpr size_t kSmem =
      1024 + 3 * kQBytes + 2 * kStages * kKVBytes + 8 * (1 + 3 * kStages);
};

// rowsum(a · b) over the head dim of row `row` of two kFlashBM-row tiles in
// shared memory (undoing the panels' swizzle: 16-byte chunk c of a row of
// panel width PW lies at chunk c ^ ((row · PW · 2 / 128) mod PW / 8)); the
// four threads of a quad (t = 0..3) take every fourth chunk and each returns
// the row's whole sum.
template <int HD>
__device__ __forceinline__ float tile_row_dot(const bf16* a, const bf16* b,
                                              int row, int t) {
  using P = Panels<HD>;
  constexpr int kChunks = P::kPW / 8;  // 16-byte chunks a panel row
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < HD / 32; ++i) {
    const int c = t + 4 * i;
    const int phys = (c % kChunks) ^ ((row * (int)P::kRowBytes >> 7) & (kChunks - 1));
    const int off = (c / kChunks) * kFlashBM * P::kPW + row * P::kPW + phys * 8;
    const uint4 x = *reinterpret_cast<const uint4*>(a + off);
    const uint4 y = *reinterpret_cast<const uint4*>(b + off);
    const uint32_t xv[4] = {x.x, x.y, x.z, x.w}, yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 fx = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&xv[e]));
      const float2 fy = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&yv[e]));
      s += fx.x * fy.x + fx.y * fy.y;
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s + __shfl_xor_sync(0xffffffffu, s, 2);
}

template <int HD>
struct DqRows {
  static constexpr int kBN = DqCfg<HD>::kBN;
  float s[kBN / 2];      // scores, then ds in fp32
  float dp[kBN / 2];
  uint32_t ds[kBN / 4];  // bf16 ds: the A fragments of dS·K
  float dq[HD / 2];
  float lse2[2], delta[2];  // of this thread's two rows
};

template <int HD>
__device__ __forceinline__ void issue_s_dp(DqRows<HD>& r, const bf16* Qs,
                                           const bf16* dOs, const bf16* Kt,
                                           const bf16* Vt, int row0) {
  constexpr int BM = kFlashBM, BN = DqCfg<HD>::kBN;
  sm90::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
    sm90::Wgmma<BN, 0>::ss(r.s, desc_kmajor<HD, BM>(Qs, row0, ks),
                           desc_kmajor<HD, BN>(Kt, 0, ks), ks > 0);
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
    sm90::Wgmma<BN, 0>::ss(r.dp, desc_kmajor<HD, BM>(dOs, row0, ks),
                           desc_kmajor<HD, BN>(Vt, 0, ks), ks > 0);
  sm90::wgmma_commit();
}

template <int HD>
__device__ __forceinline__ void issue_dq(DqRows<HD>& r, const bf16* Kt) {
  constexpr int BN = DqCfg<HD>::kBN;
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    sm90::Wgmma<HD, 1>::rs(r.dq, r.ds + 4 * kk, desc_mnmajor<HD, BN>(Kt, kk),
                           1);
  sm90::wgmma_commit();
}

// ds = p · (dp - delta) · scale in place of the scores; keys at or past
// `valid` give 0.
template <int HD>
__device__ __forceinline__ void ds_tile(DqRows<HD>& r, int valid, float sl2,
                                        float scale, int t) {
#pragma unroll
  for (int i = 0; i < DqCfg<HD>::kBN / 2; ++i) {
    const int h = (i >> 1) & 1;
    const float p = acc_col(i, t) < valid ? ex2(fmaf(r.s[i], sl2, -r.lse2[h]))
                                          : 0.0f;
    r.s[i] = p * (r.dp[i] - r.delta[h]) * scale;
  }
}

template <int HD>
__global__ void __launch_bounds__(kFlashThreads, 1)
    flash_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const __grid_constant__ CUtensorMap o_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const float* __restrict__ lse, float* __restrict__ lse2,
                    float* __restrict__ delta, bf16* __restrict__ dq, int Nq,
                    int Nkv, float scale, HeadLayout lay) {
  using C = DqCfg<HD>;
  constexpr int BN = C::kBN, ST = C::kStages;
  extern __shared__ unsigned char flash_smem[];
  unsigned char* base = flash_smem_base(flash_smem);
  bf16* Qs = reinterpret_cast<bf16*>(base);
  bf16* dOs = reinterpret_cast<bf16*>(base + C::kQBytes);
  bf16* Os = reinterpret_cast<bf16*>(base + 2 * C::kQBytes);
  bf16* Ks = reinterpret_cast<bf16*>(base + 3 * C::kQBytes);  // [ST][BN x HD]
  bf16* Vs = Ks + ST * BN * HD;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + ST * BN * HD);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + ST;
  uint64_t* empty = v_full + ST;

  const int bh = blockIdx.y;
  const int z = lay.seq(bh), hc = lay.head_col(bh, HD);
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
      sm90::mbar_expect_tx(q_full, 3 * C::kQBytes);
      tma_tile<HD, kFlashBM>(Qs, &q_map, q_full, lay.q_col + hc, q0, z);
      tma_tile<HD, kFlashBM>(dOs, &do_map, q_full, hc, q0, z);
      tma_tile<HD, kFlashBM>(Os, &o_map, q_full, hc, q0, z);
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

  sm90::regs_inc<kFlashConsumerRegs>();
  const int row0 = wg * 64;
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % 128) / 32;
  const int g = lane >> 2, t = lane & 3;
  // this thread's rows of the block, and of the padded row arrays the dk/dv
  // pass reads (this pass writes every padded row: the grid covers them)
  const int rb = row0 + warp * 16 + g;
  const size_t prow = (size_t)bh * padded_rows(Nq) + q0 + rb;
  if (q0 + row0 >= Nq) {  // all padding: release the stages, compute nothing
    if (t == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        lse2[prow + h * 8] = __int_as_float(0x7f800000);  // +inf: p = 0
        delta[prow + h * 8] = 0.0f;
      }
    for (int j = 0; j < nkt; ++j) {
      sm90::mbar_wait(k_full + j % ST, (j / ST) & 1);
      sm90::mbar_wait(v_full + j % ST, (j / ST) & 1);
      if (lane == 0) sm90::mbar_arrive(empty + j % ST);
    }
    return;
  }

  const float sl2 = scale * kLog2e;
  TensorTurns turns(wg, q0 + 64 < Nq ? 2 : 1);
  DqRows<HD> r;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) r.dq[i] = 0.0f;

  sm90::mbar_wait(q_full, 0);
  sm90::mbar_wait(k_full, 0);
  sm90::mbar_wait(v_full, 0);
  turns.wait();
  issue_s_dp<HD>(r, Qs, dOs, Ks, Vs, row0);
  turns.pass(false);
  // under the first products: delta = rowsum(do · o) (0 on padded rows,
  // which read zeros) and lse in base 2 (+inf on padded rows: p = 0)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + rb + h * 8;
    r.delta[h] = tile_row_dot<HD>(dOs, Os, rb + h * 8, t);
    r.lse2[h] = row < Nq ? lse[(size_t)bh * Nq + row] * kLog2e
                         : __int_as_float(0x7f800000);
    if (t == 0) {
      lse2[prow + h * 8] = r.lse2[h];
      delta[prow + h * 8] = r.delta[h];
    }
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(r.s);
  sm90::fence_regs(r.dp);
  ds_tile<HD>(r, Nkv, sl2, scale, t);
  acc_to_a<BN / 2>(r.ds, r.s);

  for (int j = 1; j < nkt; ++j) {
    const int sj = j % ST, sp = (j - 1) % ST;
    sm90::mbar_wait(k_full + sj, (j / ST) & 1);
    sm90::mbar_wait(v_full + sj, (j / ST) & 1);
    turns.wait();
    issue_s_dp<HD>(r, Qs, dOs, Ks + sj * BN * HD, Vs + sj * BN * HD, row0);
    issue_dq<HD>(r, Ks + sp * BN * HD);
    turns.pass(false);
    sm90::wgmma_wait<1>();  // S and dP of tile j; dQ of j - 1 runs on
    sm90::fence_regs(r.s);
    sm90::fence_regs(r.dp);
    ds_tile<HD>(r, Nkv - j * BN, sl2, scale, t);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(r.dq);
    sm90::fence_regs(r.s);
    if (lane == 0) sm90::mbar_arrive(empty + sp);
    acc_to_a<BN / 2>(r.ds, r.s);
  }
  turns.wait();
  issue_dq<HD>(r, Ks + ((nkt - 1) % ST) * BN * HD);
  turns.pass(true);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(r.dq);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + row0 + warp * 16 + g + h * 8;
    if (row >= Nq) continue;
    bf16* dst = dq + lay.out_row(bh, Nq, row, lay.q_ld, HD) + 2 * t;
#pragma unroll
    for (int jn = 0; jn < HD / 8; ++jn)
      *reinterpret_cast<__nv_bfloat162*>(dst + jn * 8) =
          __floats2bfloat162_rn(r.dq[4 * jn + 2 * h], r.dq[4 * jn + 2 * h + 1]);
  }
}

// ---- 2. dk, dv ----------------------------------------------------------------

template <int HD>
struct DkvCfg {
  static constexpr int kStages = 2;
  static constexpr bool kRegA = HD == 64;  // K and V as register fragments
  static constexpr uint32_t kTileBytes = 64 * HD * 2;  // K, V, a Q or dO tile
  static constexpr uint32_t kRowBytes = kFlashBQ * 4;  // lse or delta of one
  static constexpr uint32_t kLoadBytes = 2 * kTileBytes + 2 * kRowBytes;
  static constexpr uint32_t kStageBytes =  // kept 1024-byte aligned
      (kLoadBytes + 1023) / 1024 * 1024;
  static constexpr size_t kSmem =
      1024 + 2 * kTileBytes + kStages * kStageBytes + 8 * (1 + 2 * kStages);
};

template <int HD>
__global__ void __launch_bounds__(256, 2)
    flash_dkdv_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap do_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const float* __restrict__ lse2,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, float* __restrict__ dk_part,
                      float* __restrict__ dv_part, int BH, int Nq, int Nkv,
                      float scale, int per_split, HeadLayout lay) {
  using C = DkvCfg<HD>;
  constexpr int ST = C::kStages;
  constexpr int BQ = kFlashBQ;
  extern __shared__ unsigned char flash_smem[];
  unsigned char* base = flash_smem_base(flash_smem);
  bf16* Ks = reinterpret_cast<bf16*>(base);
  bf16* Vs = reinterpret_cast<bf16*>(base + C::kTileBytes);
  unsigned char* ring = base + 2 * C::kTileBytes;  // [ST][Q, dO, lse2, delta]
  uint64_t* kv_full =
      reinterpret_cast<uint64_t*>(ring + ST * C::kStageBytes);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + ST;
  auto stage_q = [&](int s) {
    return reinterpret_cast<bf16*>(ring + s * C::kStageBytes);
  };
  auto stage_do = [&](int s) {
    return reinterpret_cast<bf16*>(ring + s * C::kStageBytes + C::kTileBytes);
  };
  auto stage_rows = [&](int s) {  // lse2 [BQ], then delta [BQ]
    return reinterpret_cast<float*>(ring + s * C::kStageBytes +
                                    2 * C::kTileBytes);
  };

  const int k0 = blockIdx.x * 64;
  const int bh = blockIdx.y;
  const int z = lay.seq(bh), hc = lay.head_col(bh, HD);
  const int split = blockIdx.z;
  const int nqt = (Nq + BQ - 1) / BQ;
  const int qt0 = split * per_split;
  const int qt1 = min(nqt, qt0 + per_split);
  const int n = qt1 - qt0;
  const size_t prow = (size_t)bh * padded_rows(Nq);
  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, 4);  // the consumer's four warps
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // producer warpgroup
    sm90::regs_dec<24>();
    if (threadIdx.x == 128) {
      sm90::mbar_expect_tx(kv_full, 2 * C::kTileBytes);
      tma_tile<HD, 64>(Ks, &k_map, kv_full, lay.k_col + hc, k0, z);
      tma_tile<HD, 64>(Vs, &v_map, kv_full, lay.v_col + hc, k0, z);
      for (int i = 0; i < n; ++i) {
        const int s = i % ST, q = (qt0 + i) * BQ;
        if (i >= ST) sm90::mbar_wait(empty + s, (i / ST - 1) & 1);
        sm90::mbar_expect_tx(full + s, C::kLoadBytes);
        tma_tile<HD, BQ>(stage_q(s), &q_map, full + s, lay.q_col + hc, q, z);
        tma_tile<HD, BQ>(stage_do(s), &do_map, full + s, hc, q, z);
        sm90::bulk_load(stage_rows(s), lse2 + prow + q, C::kRowBytes, full + s);
        sm90::bulk_load(stage_rows(s) + BQ, delta + prow + q, C::kRowBytes,
                        full + s);
      }
    }
    return;
  }

  sm90::regs_inc<232>();
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane >> 2, t = lane & 3;
  const float sl2 = scale * kLog2e;
  float acc_dk[HD / 2], acc_dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc_dk[i] = acc_dv[i] = 0.0f;

  sm90::mbar_wait(kv_full, 0);
  uint32_t ka[16], va[16];  // K and V rows as A fragments (C::kRegA)
  if constexpr (C::kRegA) {
    load_a_frags(ka, Ks, warp * 16, lane);
    load_a_frags(va, Vs, warp * 16, lane);
  }
  for (int i = 0; i < n; ++i) {
    const int s = i % ST;
    sm90::mbar_wait(full + s, (i / ST) & 1);
    const bf16* Qt = stage_q(s);
    const bf16* dOt = stage_do(s);
    float st[BQ / 2], dpt[BQ / 2];  // Sᵀ, dPᵀ: 64 keys x 64 queries
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      if constexpr (C::kRegA)
        sm90::Wgmma<BQ, 0>::rs(st, ka + 4 * ks,
                               desc_kmajor<HD, BQ>(Qt, 0, ks), ks > 0);
      else
        sm90::Wgmma<BQ, 0>::ss(st, desc_kmajor<HD, 64>(Ks, 0, ks),
                               desc_kmajor<HD, BQ>(Qt, 0, ks), ks > 0);
    }
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      if constexpr (C::kRegA)
        sm90::Wgmma<BQ, 0>::rs(dpt, va + 4 * ks,
                               desc_kmajor<HD, BQ>(dOt, 0, ks), ks > 0);
      else
        sm90::Wgmma<BQ, 0>::ss(dpt, desc_kmajor<HD, 64>(Vs, 0, ks),
                               desc_kmajor<HD, BQ>(dOt, 0, ks), ks > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);

    // columns are queries: lse2 and delta by column, from the stage
    const float* rows = stage_rows(s);
    uint32_t pf[BQ / 4], dsf[BQ / 4];
#pragma unroll
    for (int jn = 0; jn < BQ / 8; ++jn) {
      const int col = jn * 8 + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(rows + col);
      const float2 dl = *reinterpret_cast<const float2*>(rows + BQ + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i4 = 4 * jn + e;
        const float lc = (e & 1) ? l2.y : l2.x;
        const float dc = (e & 1) ? dl.y : dl.x;
        const float p = ex2(fmaf(st[i4], sl2, -lc));  // 0 for padded queries
        st[i4] = p;
        dpt[i4] = p * (dpt[i4] - dc) * scale;
      }
    }
    acc_to_a<BQ / 2>(pf, st);
    acc_to_a<BQ / 2>(dsf, dpt);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      sm90::Wgmma<HD, 1>::rs(acc_dv, pf + 4 * kk,
                             desc_mnmajor<HD, BQ>(dOt, kk), 1);
      sm90::Wgmma<HD, 1>::rs(acc_dk, dsf + 4 * kk,
                             desc_mnmajor<HD, BQ>(Qt, kk), 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc_dv);
    sm90::fence_regs(acc_dk);
    if (lane == 0) sm90::mbar_arrive(empty + s);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k0 + warp * 16 + g + h * 8;
    if (row >= Nkv) continue;
    if (dk_part == nullptr) {  // one split: the sums are final
      const size_t off = lay.out_row(bh, Nkv, row, lay.kv_ld, HD) + 2 * t;
      bf16* kr = dk + off;
      bf16* vr = dv + off;
#pragma unroll
      for (int jn = 0; jn < HD / 8; ++jn) {
        *reinterpret_cast<__nv_bfloat162*>(kr + jn * 8) = __floats2bfloat162_rn(
            acc_dk[4 * jn + 2 * h], acc_dk[4 * jn + 2 * h + 1]);
        *reinterpret_cast<__nv_bfloat162*>(vr + jn * 8) = __floats2bfloat162_rn(
            acc_dv[4 * jn + 2 * h], acc_dv[4 * jn + 2 * h + 1]);
      }
    } else {
      const size_t off = (((size_t)split * BH + bh) * Nkv + row) * HD + 2 * t;
#pragma unroll
      for (int jn = 0; jn < HD / 8; ++jn) {
        *reinterpret_cast<float2*>(dk_part + off + jn * 8) =
            make_float2(acc_dk[4 * jn + 2 * h], acc_dk[4 * jn + 2 * h + 1]);
        *reinterpret_cast<float2*>(dv_part + off + jn * 8) =
            make_float2(acc_dv[4 * jn + 2 * h], acc_dv[4 * jn + 2 * h + 1]);
      }
    }
  }
}

// ---- 3. sum the partials in split order --------------------------------------

// part: `splits` blocks of (BH, Nkv, hd) fp32; out as `lay` places dk / dv.
__global__ void __launch_bounds__(256)
    flash_sum_splits_kernel(const float* __restrict__ part,
                            bf16* __restrict__ out, size_t n, int splits,
                            int Nkv, int hd, HeadLayout lay) {
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int z = 0; z < splits; ++z) s += part[(size_t)z * n + i];
  const size_t row = i / hd;  // (bh, key row) flattened
  const int bh = (int)(row / Nkv), r = (int)(row % Nkv);
  out[lay.out_row(bh, Nkv, r, lay.kv_ld, hd) + i % hd] = __float2bfloat16(s);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Maps of the operands: q, do and o in kFlashBM-row boxes and k and v in
// DqCfg::kBN-row boxes (the dq pass), q and do in kFlashBQ-row and k and v
// in 64-row boxes (the dk/dv pass).
enum BwdOperand { kBwdQ, kBwdK, kBwdV, kBwdO, kBwdDO };
struct FlashBwdMaps {
  CUtensorMap q_dq, do_dq, o_dq, k_dq, v_dq, q_kv, do_kv, k_kv, v_kv;
};

// Encodes the maps the backward at HD reads; mk(map, operand, box rows)
// encodes one.
template <int HD, class MakeMap>
bool flash_bwd_maps(FlashBwdMaps& m, MakeMap mk) {
  constexpr int BN = DqCfg<HD>::kBN;
  return mk(&m.q_dq, kBwdQ, kFlashBM) && mk(&m.do_dq, kBwdDO, kFlashBM) &&
         mk(&m.o_dq, kBwdO, kFlashBM) && mk(&m.k_dq, kBwdK, BN) &&
         mk(&m.v_dq, kBwdV, BN) && mk(&m.q_kv, kBwdQ, kFlashBQ) &&
         mk(&m.do_kv, kBwdDO, kFlashBQ) && mk(&m.k_kv, kBwdK, 64) &&
         mk(&m.v_kv, kBwdV, 64);
}

// fp32 floats of the row arrays (lse·log2e and delta, each padded to a
// multiple of 128 query rows a slice) and of the dk and dv partials of
// every query split (0 with one split).
inline size_t flash_bwd_row_floats(int BH, int Nq) {
  return 2 * (size_t)BH * padded_rows(Nq);
}

inline size_t flash_bwd_scratch_floats(int BH, int Nq, int Nkv, int hd) {
  const int splits = bwd_splits(BH, Nq, Nkv);
  return splits > 1 ? 2 * (size_t)splits * BH * Nkv * hd : 0;
}

// The backward over BH slices laid out as `lay` says, from the maps
// flash_bwd_maps encoded; `rows` and `scratch` hold flash_bwd_row_floats
// and flash_bwd_scratch_floats.
template <int HD>
cudaError_t launch_flash_bwd(const FlashBwdMaps& m, const float* lse,
                             float* rows, float* scratch, bf16* dq, bf16* dk,
                             bf16* dv, int BH, int Nq, int Nkv, float scale,
                             const HeadLayout& lay, cudaStream_t st) {
  float* lse2 = rows;
  float* delta = rows + (size_t)BH * padded_rows(Nq);
  cudaError_t err = allow_smem(flash_dq_kernel<HD>, DqCfg<HD>::kSmem);
  if (err != cudaSuccess) return err;
  dim3 dq_grid((Nq + kFlashBM - 1) / kFlashBM, BH);
  flash_dq_kernel<HD><<<dq_grid, kFlashThreads, DqCfg<HD>::kSmem, st>>>(
      m.q_dq, m.do_dq, m.o_dq, m.k_dq, m.v_dq, lse, lse2, delta, dq, Nq, Nkv,
      scale, lay);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int per = bwd_tiles_per_split(BH, Nq, Nkv);
  const int splits = bwd_splits(BH, Nq, Nkv);
  const size_t n = (size_t)BH * Nkv * HD;
  float* dk_part = splits > 1 ? scratch : nullptr;
  float* dv_part = splits > 1 ? scratch + (size_t)splits * n : nullptr;
  err = allow_smem(flash_dkdv_kernel<HD>, DkvCfg<HD>::kSmem);
  if (err != cudaSuccess) return err;
  dim3 kv_grid((Nkv + 63) / 64, BH, splits);
  flash_dkdv_kernel<HD><<<kv_grid, 256, DkvCfg<HD>::kSmem, st>>>(
      m.q_kv, m.do_kv, m.k_kv, m.v_kv, lse2, delta, dk, dv, dk_part, dv_part,
      BH, Nq, Nkv, scale, per, lay);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;

  const unsigned blocks = (unsigned)((n + 255) / 256);
  flash_sum_splits_kernel<<<blocks, 256, 0, st>>>(dk_part, dk, n, splits, Nkv,
                                                   HD, lay);
  flash_sum_splits_kernel<<<blocks, 256, 0, st>>>(dv_part, dv, n, splits, Nkv,
                                                   HD, lay);
  return cudaGetLastError();
}

}  // namespace vt
