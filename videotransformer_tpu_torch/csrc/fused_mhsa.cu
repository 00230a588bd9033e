// Fused prenorm multi-head self-attention, forward, for Hopper (sm_90a).
//
// Replaces videotransformer_tpu/kernels/fused_mhsa_pallas.py::_kernel (the
// forward body reached through _fwd / fused_prenorm_mhsa). Per sequence:
//
//   xn   = bf16(LayerNorm(x) with fp32 statistics)
//   qkv  = bf16(xn · Wqkvᵀ + bqkv)                         fp32 accumulate
//   per head: s = (q kᵀ) * scale (fp32), p = exp(s - max(s)),
//             o = bf16((bf16(p) · v) / sum(p))             deferred softmax
//   out  = bf16(concat(o) · Wprojᵀ + bproj [+ x])          fp32 accumulate
//
// `seq_len` = L cuts the rows into independent length-L sequences: L = N is
// dense attention (divided spatial, N = 197), L = block_diag is the TPU
// kernel's block-diagonal mode (divided temporal, L = 8).
//
// Bound: at the TimeSformer shapes the two projections carry ~97% of the
// FLOPs (8·rows·D·Da of 8·rows·D·Da + 4·rows·L·Da), so the tensor-core rate
// bounds the call; at the joint space-time length L = 1569 attention
// carries half (60.5 of 119.7 GFLOP at (8, 1569, 768)), still on the tensor
// cores. Design (four launches on the caller's stream):
//
// 1. LayerNorm statistics: (mean, rstd) of each row, 8 bytes a row.
// 2. qkv = LN(x) · Wqkvᵀ + b on the wgmma/TMA core (sm90_gemm.cuh) with the
//    LayerNorm applied to each A tile in shared memory (LN_A): xn never
//    reaches device memory.
// 3. Attention on the tensor cores, Q, K and V of a head by TMA from qkv:
//    - dense (L <= 256, head dim 64; L = 197): a block per sequence and
//      three heads, the whole Q, K and V of a head in shared memory
//      (zero-filled past L), the next head's loading while this one
//      computes; each warpgroup takes 64-query tiles: S = Q·Kᵀ as two
//      wgmma products (128 + 80 keys at L = 197), the row's scores in
//      registers, softmax, O = P̃·V with P̃ from registers;
//    - packed (64 % L == 0, head dim 64; L = 8): eight sequences share a
//      64-row wgmma tile, and a block-diagonal mask gives every key outside
//      a row's own sequence p = 0 exactly (the TPU kernel's _score_chunk
//      packing); the ×64/L masked products are free at the tensor cores'
//      rate, so the stage is bound by reading qkv;
//    - long (L > 256, head dim 64; joint space-time attention, L = 1569):
//      B5's one-pass flash kernel (flash_fwd.cuh) reading each head's q, k
//      and v in place from qkv through 3-D maps over (sequence, L, 3Da),
//      the head's columns a coordinate of the box, and writing its output
//      rows into attn (row stride Da) and the fp32 row log-sum-exp into
//      lse (sequence, head, L), which the backward's long variant reads;
//    - any other head dim or length: a CUDA-core kernel, one warp a query
//      row (off the main paths).
//    The rounding points of dense, packed and the CUDA-core kernel are the
//    TPU kernel's: fp32 scores × scale, the max
//    over the row's own keys, p = exp(s - max) in fp32, the row sum taken
//    before p is rounded to bf16 for P̃·V, O / sum rounded once. The exp is
//    the special function unit's (__expf: a few fp32 ulps, far inside the
//    bf16 rounding of p that follows): inlined 104 times a thread, expf's
//    longer sequence took the dense stage from 0.23 to 0.33 ms on an H100.
//    The long variant walks the keys in 80-key tiles with an online softmax
//    and so rounds the unnormalised p̃ = exp(s - m_running) before P̃·V
//    (B5's order, kernels/flash_attention.py).
// 4. out = attn · Wprojᵀ + b (+ x in the epilogue) on the same core.
//
// What stays in device memory: qkv (rows x 3Da bf16, written and read once)
// and attn (rows x Da, the same), in every mode of the wrapper; the train
// step keeps both for the backward (the TPU kernel's save_qkv/save_attn),
// or attn alone with the wrapper's RECOMPUTE_QKV on, when B3 runs steps 1
// and 2 again (sm90_gemm.cuh::launch_ln_linear, the same code).

#include "flash_common.cuh"
#include "flash_fwd.cuh"
#include "layernorm.cuh"  // warp_sum, warp_max (the CUDA-core kernel)
#include "sm90_gemm.cuh"

namespace vt {

// ---- other shapes: the CUDA-core kernel ------------------------------------

constexpr int kAttnWarps = 8;
constexpr int kAttnRowsTarget = 128;  // short sequences are grouped per block

__host__ __device__ inline int seqs_per_block(int L) {
  return L >= kAttnRowsTarget ? 1 : kAttnRowsTarget / L;
}

__host__ __device__ inline size_t attention_smem_bytes(int L, int hd) {
  const size_t rows = (size_t)seqs_per_block(L) * L;
  return 2 * rows * (hd + 2) * sizeof(bf16) +
         (size_t)kAttnWarps * (hd + L) * sizeof(float);
}

// grid (ceil(nseq / seqs_per_block), heads); block kAttnWarps warps.
// K and V of the block's sequences sit in shared memory with rows padded to
// hd + 2 elements (odd word stride: lanes reading different key rows hit
// different banks). Each warp takes one query row at a time: lanes split the
// keys for the scores, then split the head dims for the PV product.
__global__ void __launch_bounds__(kAttnWarps * 32)
    attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                     int nseq, int L, int Da, int hd, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int spb = seqs_per_block(L);
  const int ks = hd + 2;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + (size_t)spb * L * ks;
  float* qbuf = reinterpret_cast<float*>(Vs + (size_t)spb * L * ks);
  float* pbuf = qbuf + kAttnWarps * hd;

  const int h = blockIdx.y;
  const int s0 = blockIdx.x * spb;
  const int rows = min(spb, nseq - s0) * L;
  const size_t row0 = (size_t)s0 * L;
  const size_t ld = 3 * (size_t)Da;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const int hd2 = hd / 2;
  for (int idx = threadIdx.x; idx < rows * hd2; idx += blockDim.x) {
    const int r = idx / hd2;
    const int d = (idx % hd2) * 2;
    const bf16* src = qkv + (row0 + r) * ld + h * hd + d;
    *reinterpret_cast<__nv_bfloat162*>(Ks + r * ks + d) =
        *reinterpret_cast<const __nv_bfloat162*>(src + Da);
    *reinterpret_cast<__nv_bfloat162*>(Vs + r * ks + d) =
        *reinterpret_cast<const __nv_bfloat162*>(src + 2 * Da);
  }
  __syncthreads();

  float* q = qbuf + warp * hd;
  float* p = pbuf + warp * L;
  for (int r = warp; r < rows; r += kAttnWarps) {
    const int kbeg = (r / L) * L;  // first key row of this row's sequence
    const bf16* qsrc = qkv + (row0 + r) * ld + h * hd;
    for (int d = lane; d < hd; d += 32) q[d] = __bfloat162float(qsrc[d]);
    __syncwarp();

    float mx = __int_as_float(0xff800000);  // -inf
    for (int j = lane; j < L; j += 32) {
      const bf16* kr = Ks + (kbeg + j) * ks;
      float s = 0.0f;
      for (int d = 0; d < hd; d += 2) {
        const float2 kf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(kr + d));
        s += q[d] * kf.x + q[d + 1] * kf.y;
      }
      s *= scale;
      p[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(p[j] - mx);
      sum += e;  // the row sum is taken before p is rounded
      p[j] = __bfloat162float(__float2bfloat16(e));
    }
    sum = warp_sum(sum);
    __syncwarp();

    bf16* dst = out + (row0 + r) * Da + h * hd;
    for (int d = lane; d < hd; d += 32) {
      float o = 0.0f;
      for (int j = 0; j < L; ++j)
        o += p[j] * __bfloat162float(Vs[(kbeg + j) * ks + d]);
      dst[d] = __float2bfloat16(o / sum);
    }
    __syncwarp();  // q and p are rewritten by this warp's next row
  }
}

// ---- the tensor-core kernels (head dim 64) ----------------------------------

constexpr int kHd = 64;
constexpr uint32_t kTileBytes = 64 * kHd * 2;  // one 64-row tile of a head

enum Variant { kGeneral = 0, kPacked = 1, kDense = 2, kLong = 3 };

// O (64 x 64) / sum, rounded to bf16, into rows row0.. (of `limit`) of
// `out` (row stride Da) at column col, 16 bytes a lane (quad_transpose).
__device__ __forceinline__ void store_rows(const float (&o)[32],
                                           const float (&sum)[2], bf16* out,
                                           size_t row_base, int row0,
                                           int limit, int Da, int col) {
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % 128) / 32;
  const int t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + warp * 16 + (lane >> 2) + 8 * h;
#pragma unroll
    for (int j0 = 0; j0 < kHd / 8; j0 += 4) {
      uint32_t x[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j0 + jj;
        x[jj] = wg::pack2(o[4 * j + 2 * h] / sum[h],
                          o[4 * j + 2 * h + 1] / sum[h]);
      }
      const uint4 v = wg::quad_transpose(x, t);
      if (row < limit)
        *reinterpret_cast<uint4*>(out + (row_base + row) * Da + col +
                                  (j0 + t) * 8) = v;
    }
  }
}

// Dense: grid (nseq, ceil(heads / kDenseHeads)); two consumer warpgroups
// and a producer warpgroup that gives them its registers. Each block takes
// kDenseHeads heads of one sequence in turn through two stages of shared
// memory, so the next head's Q, K and V load while this one computes. Keys
// padded to N1 + N2 (S in two products of N1 and N2 keys, N2 may be 0);
// queries in up to four 64-row tiles, warpgroup w taking tiles w and w + 2.
constexpr int kDenseHeads = 3;

template <int N1, int N2>
struct DenseCfg {
  static constexpr int kKeys = N1 + N2;
  static constexpr uint32_t kStageBytes = 4 * kTileBytes + 2 * kKeys * kHd * 2;
  static constexpr size_t kSmem = 1024 + 2 * (size_t)kStageBytes + 32;
};

template <int N1, int N2>
__global__ void __launch_bounds__(384, 1)
    attention_dense_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap kv_map,
                           bf16* __restrict__ out, int L, int Da, int heads,
                           float scale) {
  using Cfg = DenseCfg<N1, N2>;
  constexpr int KP = Cfg::kKeys;
  extern __shared__ unsigned char attn_smem[];
  unsigned char* base = flash_smem_base(attn_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + 2 * Cfg::kStageBytes);
  uint64_t* empty = full + 2;
  const int seq = blockIdx.x;
  const int h0 = blockIdx.y * kDenseHeads;
  const int nh = min(kDenseHeads, heads - h0);
  const int nq = (L + 63) / 64;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, 8);  // the consumers' eight warps
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer
    sm90::regs_dec<24>();
    if (threadIdx.x == 256) {
      for (int i = 0; i < nh; ++i) {
        const int s = i & 1, head = h0 + i;
        if (i >= 2) sm90::mbar_wait(empty + s, ((i >> 1) - 1) & 1);
        bf16* Qs = reinterpret_cast<bf16*>(base + s * Cfg::kStageBytes);
        bf16* Ks = Qs + 4 * 64 * kHd;
        sm90::mbar_expect_tx(full + s, nq * kTileBytes + 2 * KP * kHd * 2);
        for (int q = 0; q < nq; ++q)
          sm90::tma_load_3d(Qs + q * 64 * kHd, &q_map, full + s, head * kHd,
                            64 * q, seq);
        sm90::tma_load_3d(Ks, &kv_map, full + s, Da + head * kHd, 0, seq);
        sm90::tma_load_3d(Ks + KP * kHd, &kv_map, full + s,
                          2 * Da + head * kHd, 0, seq);
      }
    }
    return;
  }

  sm90::regs_inc<240>();
  const int wgi = threadIdx.x / 128;
  const int t = threadIdx.x % 4;
  const float neg = neg_inf();
  auto valid = [L](int, int col) { return col < L; };
  for (int i = 0; i < nh; ++i) {
    const int s = i & 1, head = h0 + i;
    const bf16* Qs = reinterpret_cast<const bf16*>(base + s * Cfg::kStageBytes);
    const bf16* Ks = Qs + 4 * 64 * kHd;
    const bf16* Vs = Ks + KP * kHd;
    sm90::mbar_wait(full + s, (i >> 1) & 1);
    for (int qt = wgi; qt < nq; qt += 2) {
      const bf16* Qt = Qs + qt * 64 * kHd;
      float s1[N1 / 2];
      float s2[N2 > 0 ? N2 / 2 : 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kHd / 16; ++ks)
        sm90::Wgmma<N1, 0>::ss(s1, desc_kmajor<kHd, 64>(Qt, 0, ks),
                               desc_kmajor<kHd, KP>(Ks, 0, ks), ks > 0);
      if constexpr (N2 > 0) {
#pragma unroll
        for (int ks = 0; ks < kHd / 16; ++ks)
          sm90::Wgmma<N2, 0>::ss(s2, desc_kmajor<kHd, 64>(Qt, 0, ks),
                                 desc_kmajor<kHd, KP>(Ks, N1, ks), ks > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s1);
      sm90::fence_regs(s2);

      float mx[2] = {neg, neg}, sum[2] = {0.0f, 0.0f};
      scale_and_max(s1, mx, 0, t, scale, valid);
      if constexpr (N2 > 0) scale_and_max(s2, mx, N1, t, scale, valid);
      quad_reduce(mx, true);
      exp_and_sum(s1, mx, sum, 0, t, valid);
      if constexpr (N2 > 0) exp_and_sum(s2, mx, sum, N1, t, valid);
      quad_reduce(sum, false);

      // O = P̃·V in two steps, so that only one of p1, p2 is live
      float o[kHd / 2];
      {
        uint32_t p1[N1 / 4];
        acc_to_a<N1 / 2>(p1, s1);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < N1 / 16; ++kk)
          sm90::Wgmma<kHd, 1>::rs(o, p1 + 4 * kk,
                                  desc_mnmajor<kHd, KP>(Vs, kk), kk > 0);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(p1);
        sm90::fence_regs(o);
      }
      if constexpr (N2 > 0) {
        uint32_t p2[N2 / 4];
        acc_to_a<N2 / 2>(p2, s2);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < N2 / 16; ++kk)
          sm90::Wgmma<kHd, 1>::rs(o, p2 + 4 * kk,
                                  desc_mnmajor<kHd, KP>(Vs, N1 / 16 + kk), 1);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(p2);
        sm90::fence_regs(o);
      }
      store_rows(o, sum, out, (size_t)seq * L, qt * 64, L, Da, head * kHd);
    }
    if (threadIdx.x % 32 == 0) sm90::mbar_arrive(empty + s);
  }
}

// Packed: grid (ceil(rows / 128), heads), two warpgroups, each one 64-row
// tile of 64 / L whole sequences; keys of another sequence are masked.
constexpr size_t kPackedSmem = 1024 + 6 * (size_t)kTileBytes + 8;

__global__ void __launch_bounds__(256)
    attention_packed_kernel(const __grid_constant__ CUtensorMap map,
                            bf16* __restrict__ out, int rows, int L, int Da,
                            float scale) {
  extern __shared__ unsigned char attn_smem[];
  unsigned char* base = flash_smem_base(attn_smem);
  bf16* Qs = reinterpret_cast<bf16*>(base);  // [2][64 x 64]
  bf16* Ks = Qs + 2 * 64 * kHd;
  bf16* Vs = Ks + 2 * 64 * kHd;
  uint64_t* bar = reinterpret_cast<uint64_t*>(Vs + 2 * 64 * kHd);
  const int r0 = blockIdx.x * 128, head = blockIdx.y;
  if (threadIdx.x == 0) {
    sm90::mbar_init(bar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sm90::mbar_expect_tx(bar, 6 * kTileBytes);
    for (int w = 0; w < 2; ++w) {
      const int off = w * 64 * kHd;
      sm90::tma_load_3d(Qs + off, &map, bar, head * kHd, r0 + 64 * w, 0);
      sm90::tma_load_3d(Ks + off, &map, bar, Da + head * kHd, r0 + 64 * w, 0);
      sm90::tma_load_3d(Vs + off, &map, bar, 2 * Da + head * kHd, r0 + 64 * w,
                        0);
    }
  }
  const int wgi = threadIdx.x / 128;
  if (r0 + 64 * wgi >= rows) return;  // warpgroup 0 keeps the block alive
  const int t = threadIdx.x % 4;
  const int rbase = ((threadIdx.x % 128) / 32) * 16 + (threadIdx.x % 32) / 4;
  const float neg = neg_inf();
  // row (rbase + 8h) and key col of the tile lie in the same sequence
  auto valid = [rbase, L](int h, int col) {
    return (rbase + 8 * h) / L == col / L;
  };
  const int off = wgi * 64 * kHd;
  sm90::mbar_wait(bar, 0);

  float s[32];
  sm90::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kHd / 16; ++ks)
    sm90::Wgmma<64, 0>::ss(s, desc_kmajor<kHd, 64>(Qs + off, 0, ks),
                           desc_kmajor<kHd, 64>(Ks + off, 0, ks), ks > 0);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(s);

  float mx[2] = {neg, neg}, sum[2] = {0.0f, 0.0f};
  scale_and_max(s, mx, 0, t, scale, valid);
  quad_reduce(mx, true);
  exp_and_sum(s, mx, sum, 0, t, valid);
  quad_reduce(sum, false);

  uint32_t p[16];
  acc_to_a<32>(p, s);
  float o[kHd / 2];
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    sm90::Wgmma<kHd, 1>::rs(o, p + 4 * kk, desc_mnmajor<kHd, 64>(Vs + off, kk),
                            kk > 0);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(p);
  sm90::fence_regs(o);
  store_rows(o, sum, out, 0, r0 + 64 * wgi, rows, Da, head * kHd);
}

inline bool variant_fits(int variant, int L, int hd) {
  if (variant == kPacked) return hd == kHd && L >= 1 && 64 % L == 0;
  if (variant == kDense) return hd == kHd && L >= 1 && L <= 256;
  if (variant == kLong) return hd == kHd && L > 256;
  return variant == kGeneral && L >= 1 && hd >= 2 && hd % 2 == 0;
}

inline size_t dense_smem(int L) {
  if (L <= 64) return DenseCfg<64, 0>::kSmem;
  if (L <= 128) return DenseCfg<128, 0>::kSmem;
  if (L <= 208) return DenseCfg<128, 80>::kSmem;
  return DenseCfg<128, 128>::kSmem;
}

template <int N1, int N2>
cudaError_t launch_dense(const bf16* qkv, bf16* attn, int nseq, int L, int Da,
                         int heads, float scale, cudaStream_t st) {
  CUtensorMap qm, kvm;
  if (!make_tensor_map_3d(&qm, qkv, nseq, L, 3 * Da, 64, kHd) ||
      !make_tensor_map_3d(&kvm, qkv, nseq, L, 3 * Da, N1 + N2, kHd))
    return cudaErrorInvalidValue;
  constexpr size_t smem = DenseCfg<N1, N2>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      attention_dense_kernel<N1, N2>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nseq, (heads + kDenseHeads - 1) / kDenseHeads);
  attention_dense_kernel<N1, N2><<<grid, 384, smem, st>>>(qm, kvm, attn, L,
                                                          Da, heads, scale);
  return cudaGetLastError();
}

// Long: slice bh = (sequence, head) of B5's kernel, in place in qkv and attn.
cudaError_t launch_long(const bf16* qkv, bf16* attn, float* lse, int nseq,
                        int L, int Da, int heads, float scale,
                        cudaStream_t st) {
  CUtensorMap qm, kvm;
  if (lse == nullptr ||
      !make_tensor_map_3d(&qm, qkv, nseq, L, 3 * Da, kFlashBM, kHd) ||
      !make_tensor_map_3d(&kvm, qkv, nseq, L, 3 * Da, kFlashBN, kHd))
    return cudaErrorInvalidValue;
  const HeadLayout lay{heads, 0, Da, 2 * Da, Da, Da};
  return launch_flash_fwd<kHd>(qm, kvm, kvm, attn, lse, nseq * heads, L, L,
                               scale, lay, st);
}

cudaError_t launch_attention(int variant, const bf16* qkv, bf16* attn,
                             float* lse, int rows, int L, int Da, int heads,
                             float scale, cudaStream_t st) {
  const int hd = Da / heads;
  const int nseq = rows / L;
  if (variant == kLong)
    return launch_long(qkv, attn, lse, nseq, L, Da, heads, scale, st);
  if (variant == kDense) {
    if (L <= 64)
      return launch_dense<64, 0>(qkv, attn, nseq, L, Da, heads, scale, st);
    if (L <= 128)
      return launch_dense<128, 0>(qkv, attn, nseq, L, Da, heads, scale, st);
    if (L <= 208)
      return launch_dense<128, 80>(qkv, attn, nseq, L, Da, heads, scale, st);
    return launch_dense<128, 128>(qkv, attn, nseq, L, Da, heads, scale, st);
  }
  cudaError_t err;
  if (variant == kPacked) {
    CUtensorMap m;
    if (!make_tensor_map_3d(&m, qkv, 1, rows, 3 * Da, 64, kHd))
      return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(attention_packed_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kPackedSmem);
    if (err != cudaSuccess) return err;
    attention_packed_kernel<<<dim3((rows + 127) / 128, heads), 256,
                              kPackedSmem, st>>>(m, attn, rows, L, Da, scale);
    return cudaGetLastError();
  }
  const int spb = seqs_per_block(L);
  const size_t smem = attention_smem_bytes(L, hd);
  err = cudaFuncSetAttribute(attention_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  attention_kernel<<<dim3((nseq + spb - 1) / spb, heads), kAttnWarps * 32,
                     smem, st>>>(qkv, attn, nseq, L, Da, hd, scale);
  return cudaGetLastError();
}

}  // namespace vt

extern "C" {

// The version of this library's C entry points, for a tool that calls
// another checkout's build: 2 since the long attention variant added the lse
// pointer. A library without this entry point is version 1.
int vt_mhsa_abi_version() { return 2; }

// Dynamic shared memory the attention stage's `variant` (0 the CUDA-core
// kernel, 1 packed, 2 dense, 3 long; the wrapper chooses) needs at (L, hd), or -1
// when the variant does not take the shape. The wrapper refuses shapes
// above the card's 227 KB per block.
int vt_mhsa_attention_smem_bytes(int seq_len, int head_dim, int variant) {
  if (!vt::variant_fits(variant, seq_len, head_dim)) return -1;
  if (variant == vt::kPacked) return (int)vt::kPackedSmem;
  if (variant == vt::kDense) return (int)vt::dense_smem(seq_len);
  if (variant == vt::kLong) return (int)vt::FwdCfg<vt::kHd>::kSmem;
  return (int)vt::attention_smem_bytes(seq_len, head_dim);
}

// x (rows, D) with rows = nseq * seq_len; weights in (out, in) layout:
// w_qkv (3Da, D), w_proj (Do, Da). stats (rows float2), qkv (rows, 3Da),
// attn (rows, Da) and, for the long variant, lse (nseq, heads, seq_len)
// fp32 (else unused, may be null) are caller-allocated; qkv, attn and lse
// hold the saved residuals when the call returns.
int vt_fused_prenorm_mhsa(const void* x, const void* ln_w, const void* ln_b,
                          const void* w_qkv, const void* b_qkv,
                          const void* w_proj, const void* b_proj, void* stats,
                          void* qkv, void* attn, void* lse, void* out,
                          int rows, int D,
                          int Da, int Do, int num_heads, int seq_len,
                          int variant, float scale, float ln_eps,
                          int add_residual, void* stream) {
  using vt::bf16;
  namespace wg = vt::wg;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 1 || num_heads < 1 || seq_len < 1 || rows % seq_len ||
      Da % num_heads || D % wg::kBK ||
      !vt::variant_fits(variant, seq_len, Da / num_heads))
    return cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  cudaError_t err = wg::launch_ln_linear(
      xb, static_cast<const bf16*>(ln_w), static_cast<const bf16*>(ln_b),
      static_cast<const bf16*>(w_qkv), static_cast<const bf16*>(b_qkv),
      static_cast<float2*>(stats), static_cast<bf16*>(qkv), rows, D, 3 * Da,
      ln_eps, st);
  if (err != cudaSuccess) return err;
  err = vt::launch_attention(variant, static_cast<const bf16*>(qkv),
                             static_cast<bf16*>(attn),
                             static_cast<float*>(lse), rows, seq_len, Da,
                             num_heads, scale, st);
  if (err != cudaSuccess) return err;
  wg::Params p{};
  p.bias = static_cast<const bf16*>(b_proj);
  p.aux_in = add_residual ? xb : nullptr;
  p.C = out;
  p.M = rows;
  p.N = Do;
  p.K = Da;
  const bf16* a = static_cast<const bf16*>(attn);
  const bf16* w = static_cast<const bf16*>(w_proj);
  return add_residual
             ? wg::launch_gemm<128, 0, 0, wg::kBiasResidual>(a, w, p, 1, st)
             : wg::launch_gemm<128, 0, 0, wg::kBias>(a, w, p, 1, st);
}

}  // extern "C"
