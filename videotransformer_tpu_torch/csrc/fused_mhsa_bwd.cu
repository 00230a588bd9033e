// Fused prenorm multi-head self-attention, backward, for Hopper (sm_90a).
//
// Replaces videotransformer_tpu/kernels/fused_mhsa_pallas.py::_attn_bwd_kernel
// (reached through _attn_bwd) and the products of _vjp_bwd around it
// (fused_mhsa_pallas.py:523-556). From the output gradient g, the forward's
// saved qkv (bf16, rows x 3Da) and attn (rows x Da), per row:
//
//   db_proj = sum of g;  dw_proj = gᵀ · attn (fp32);  do = bf16(g · Wproj)
//   per sequence and head, with deferred normalisation (s = q kᵀ · scale,
//   p_un = exp(s - max), inv_l = 1 / sum p_un, all fp32):
//     dv    = bf16(p_un)ᵀ · bf16(do · inv_l)
//     dp    = do · vᵀ;  c = sum(dp · p_un) · inv_l
//     ds_un = bf16(p_un · (dp - c))
//     dq    = bf16((ds_un · k) · (scale · inv_l))
//     dk    = bf16(ds_unᵀ · bf16(q · (scale · inv_l)))
//   dqkv   = concat(dq, dk, dv) (bf16);  dbqkv = sum of dqkv over rows (fp32)
//   d_xn   = dqkv · Wqkv (fp32)
//   dx     = bf16(LayerNorm backward of d_xn [+ g]);  dln_w, dln_b (fp32)
//   dw_qkv = dqkvᵀ · bf16(LayerNorm(x)) (fp32)
//
// The rounding points are the TPU kernel's (fused_mhsa_pallas.py:351-414).
// One deviation: _vjp_bwd multiplies dqkv by the fp32 xn; here xn is the
// bf16 LayerNorm (as B4's dW1 reads it), which is what the TPU's default
// matmul precision feeds its MXU from fp32 operands too.
//
// Bound: at the train shapes the four projection-sized products (d_xn,
// dw_qkv: 2·rows·D·3Da FLOPs each; dw_proj, do: 2·rows·Da·Do each) at the
// tensor-core rate; the attention products are a few percent of that, and
// the LayerNorm passes and sums are bandwidth. Design, all launches on the
// caller's stream from one call:
// - The four products run on the wgmma/TMA core (sm90_gemm.cuh): the weight
//   gradients read g, attn, dqkv and xn MN-major as they lie, split over the
//   rows into fused_ffn.split_k slices summed in order; do with a bf16
//   epilogue; d_xn with an fp32 one.
// - Attention on the tensor cores (head dim 64), Q, K, V and dO of a head by
//   TMA, in two passes: a query pass (per 64-query tile and warpgroup: S and
//   the row statistics m, inv_l in registers, dP in key chunks twice, for c
//   and then for ds, dq = ds·K with ds from registers; it leaves m, c and
//   the scaled operands bf16(q·scale·inv_l), bf16(do·inv_l) in shared
//   memory), then a key pass (per 64-key tile: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ
//   recomputed from the stored statistics, dv += bf16(pᵀ)·bf16(do·inv_l)
//   and dk += dsᵀ·bf16(q·scale·inv_l) with pᵀ and dsᵀ from registers):
//   - dense (32 < L <= 256; the spatial L = 197): a block per (sequence,
//     head), the whole head in shared memory, keys padded as in B1's dense
//     forward (S as a 128 + 80-key product at L = 197);
//   - packed (64 % L == 0; the temporal L = 8): 64 / L sequences share a
//     64-row tile, and keys of another sequence get p = 0 exactly (B1's
//     packed forward run backward).
//   - long (L > 256; joint space-time attention, L = 1569): B6's two
//     passes (flash_bwd.cuh) on each (sequence, head) in place: q, k, v
//     read from qkv and do, o (the forward's attn) through 3-D maps over
//     (sequence, L, columns), dq, dk and dv written into dqkv (row stride
//     3Da). p = exp(s·scale - lse) from the forward's fp32 row log-sum-exp
//     and delta = rowsum(do · attn) in place of the deferred normalisation
//     above, so its rounding points are B6's: bf16(p)ᵀ·do, bf16(ds)·k,
//     bf16(ds)ᵀ·q with ds = p · (dp - delta) · scale; dk and dv sum in fp32
//     registers over the query tiles (split and summed in order only when
//     the grid is short of two blocks a SM), no atomics.
//   Other shapes (head dim != 64, or L <= 32 not dividing 64) take a
//   CUDA-core kernel, one warp per (sequence, head); off the main paths.
//   The wrapper chooses the variant (kernels/fused_mhsa.py).
// - The LayerNorm backward (with g added where the residual is) and every
//   column sum and slice sum are bwd_common.cuh's: partial rows reduced in
//   a fixed order, no atomics, the same bits on every run.
// dqkv, xn, do (bf16) and d_xn (fp32) go through device memory, where the
// TPU kernel kept its intermediates in VMEM.
//
// Recompute mode (the TPU kernel's recompute_qkv=True, fused_mhsa_pallas.py:
// 308-321, which the wrapper's RECOMPUTE_QKV selects): the forward kept no
// qkv, and the whole call first rebuilds it from x into a transient bf16
// (rows, 3Da) buffer with B1's own qkv stage (sm90_gemm.cuh::
// launch_ln_linear: the LayerNorm statistics, then the LayerNorm-folded
// product with the bias), the same code at the same shape, so the rebuilt
// qkv has the saved one's bits and every attention variant (the long one
// reads p = exp(s·scale - lse) from the forward's lse) computes what it
// computes from the saved qkv. Extra: 2·rows·D·3Da FLOPs, x read once more.

#include "bwd_common.cuh"
#include "flash_bwd.cuh"
#include "flash_common.cuh"
#include "layernorm.cuh"
#include "sm90_gemm.cuh"

namespace vt {

// ---- short sequences, CUDA cores ------------------------------------------

constexpr int kSmallWarps = 4;

__host__ __device__ inline size_t small_bwd_warp_floats(int L, int hd) {
  return 4 * (size_t)L * (hd + 1) + 2 * (size_t)L * L + L;
}

__host__ __device__ inline size_t small_bwd_smem_bytes(int L, int hd) {
  return kSmallWarps * small_bwd_warp_floats(L, hd) * sizeof(float);
}

// grid (ceil(nseq / kSmallWarps), heads); warp w of block b takes sequence
// b * kSmallWarps + w for head blockIdx.y.
__global__ void __launch_bounds__(kSmallWarps * 32)
    attention_bwd_small_kernel(const bf16* __restrict__ qkv,
                               const bf16* __restrict__ dout,
                               bf16* __restrict__ dqkv, int nseq, int L,
                               int Da, int hd, float scale) {
  extern __shared__ __align__(16) float sm_small[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int seq = blockIdx.x * kSmallWarps + warp;
  if (seq >= nseq) return;
  const int h = blockIdx.y;
  const int hs = hd + 1;  // odd stride: rows land on different banks
  float* Q = sm_small + warp * small_bwd_warp_floats(L, hd);
  float* K = Q + L * hs;
  float* V = K + L * hs;
  float* DO = V + L * hs;
  float* S = DO + L * hs;  // scores, then bf16(p_un)
  float* DP = S + L * L;   // dP, then ds_un
  float* INV = DP + L * L;

  const size_t row0 = (size_t)seq * L;
  const size_t ld = 3 * (size_t)Da;
  for (int idx = lane; idx < L * hd; idx += 32) {
    const int r = idx / hd, d = idx % hd;
    const bf16* src = qkv + (row0 + r) * ld + h * hd + d;
    Q[r * hs + d] = __bfloat162float(src[0]);
    K[r * hs + d] = __bfloat162float(src[Da]);
    V[r * hs + d] = __bfloat162float(src[2 * Da]);
    DO[r * hs + d] = __bfloat162float(dout[(row0 + r) * Da + h * hd + d]);
  }
  __syncwarp();
  for (int idx = lane; idx < L * L; idx += 32) {
    const int i = idx / L, j = idx % L;
    float s = 0.0f, dp = 0.0f;
    for (int d = 0; d < hd; ++d) {
      s += Q[i * hs + d] * K[j * hs + d];
      dp += DO[i * hs + d] * V[j * hs + d];
    }
    S[idx] = s * scale;
    DP[idx] = dp;
  }
  __syncwarp();
  for (int i = lane; i < L; i += 32) {
    float mx = __int_as_float(0xff800000);
    for (int j = 0; j < L; ++j) mx = fmaxf(mx, S[i * L + j]);
    float l = 0.0f, c = 0.0f;
    for (int j = 0; j < L; ++j) {
      const float p = expf(S[i * L + j] - mx);
      S[i * L + j] = p;
      l += p;
      c += DP[i * L + j] * p;
    }
    const float inv_l = 1.0f / l;
    c *= inv_l;
    for (int j = 0; j < L; ++j) {
      const float p = S[i * L + j];
      DP[i * L + j] = __bfloat162float(__float2bfloat16(p * (DP[i * L + j] - c)));
      S[i * L + j] = __bfloat162float(__float2bfloat16(p));
    }
    INV[i] = inv_l;
  }
  __syncwarp();
  // q and do are not needed raw any more: scale them in place
  for (int idx = lane; idx < L * hd; idx += 32) {
    const int r = idx / hd, d = idx % hd;
    Q[r * hs + d] = __bfloat162float(
        __float2bfloat16(Q[r * hs + d] * (scale * INV[r])));
    DO[r * hs + d] = __bfloat162float(__float2bfloat16(DO[r * hs + d] * INV[r]));
  }
  __syncwarp();
  for (int r = 0; r < L; ++r) {
    bf16* dst = dqkv + (row0 + r) * ld + h * hd;
    for (int d = lane; d < hd; d += 32) {
      float dq = 0.0f, dk = 0.0f, dv = 0.0f;
      for (int j = 0; j < L; ++j) {
        dq += DP[r * L + j] * K[j * hs + d];
        dk += DP[j * L + r] * Q[j * hs + d];
        dv += S[j * L + r] * DO[j * hs + d];
      }
      dst[d] = __float2bfloat16(dq * (scale * INV[r]));
      dst[Da + d] = __float2bfloat16(dk);
      dst[2 * Da + d] = __float2bfloat16(dv);
    }
  }
}

// ---- head dim 64, tensor cores ---------------------------------------------

constexpr int kBHd = 64;
constexpr uint32_t kBTile = 64 * kBHd * 2;  // one 64-row tile of a head
constexpr int kBTileElems = 64 * kBHd;

enum BwdVariant { kBwdGeneral = 0, kBwdPacked = 1, kBwdDense = 2,
                  kBwdLong = 3 };

// bf16(src · f) of this thread's two rows (warp·16 + lane/4 + 8h) of a
// 64-row tile, into dst: lane t of a quad takes the row's 16-byte chunks
// 2t and 2t + 1. Both tiles lie as TMA writes them (128-byte swizzle
// within a row), and a row's scale does not care where its chunks lie.
__device__ __forceinline__ void scale_tile_rows(bf16* dst, const bf16* src,
                                                const float (&f)[2]) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + (lane >> 2) + 8 * h;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int off = r * kBHd + (2 * t + c) * 8;
      uint4 u = *reinterpret_cast<const uint4*>(src + off);
      __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(v[e]);
        v[e] = __floats2bfloat162_rn(x.x * f[h], x.y * f[h]);
      }
      *reinterpret_cast<uint4*>(dst + off) = u;
    }
  }
}

// bf16(acc · f) of a 64 x 64 accumulator (f per row), tile rows < limit,
// into rows row0.. of `out` (row stride ld) at column col; 16 bytes a lane.
__device__ __forceinline__ void store_tile(const float (&acc)[32],
                                           const float (&f)[2], bf16* out,
                                           size_t row0, int limit, size_t ld,
                                           int col) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = warp * 16 + (lane >> 2) + 8 * h;
#pragma unroll
    for (int j0 = 0; j0 < kBHd / 8; j0 += 4) {
      uint32_t x[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j0 + jj;
        x[jj] = wg::pack2(acc[4 * j + 2 * h] * f[h],
                          acc[4 * j + 2 * h + 1] * f[h]);
      }
      const uint4 v = wg::quad_transpose(x, t);
      if (row < limit)
        *reinterpret_cast<uint4*>(out + (row0 + row) * ld + col +
                                  (j0 + t) * 8) = v;
    }
  }
}

// dp (64 x NC) = dO · V[key0 .. key0 + NC)ᵀ, both K-major 64-wide rows.
template <int NC>
__device__ __forceinline__ void dp_chunk(float (&dp)[NC / 2], const bf16* DOt,
                                         const bf16* Vs, int key0) {
  sm90::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kBHd / 16; ++ks)
    sm90::Wgmma<NC, 0>::ss(dp, desc_kmajor<kBHd, 64>(DOt, 0, ks),
                           desc_kmajor<kBHd, 64>(Vs, key0, ks), ks > 0);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(dp);
}

// cs += sum over the chunk's keys of dp · p_un; p[OFF..] are its p_un.
template <int NC, int OFF, int R>
__device__ __forceinline__ void c_chunk(const float (&p)[R], const bf16* DOt,
                                        const bf16* Vs, int key0,
                                        float (&cs)[2]) {
  float dp[NC / 2];
  dp_chunk<NC>(dp, DOt, Vs, key0);
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) cs[(i >> 1) & 1] += dp[i] * p[OFF + i];
}

// dq += bf16(p_un · (dp - c)) · K[key0 .. key0 + NC), ds from registers.
template <int NC, int OFF, int R>
__device__ __forceinline__ void dq_chunk(const float (&p)[R],
                                         const float (&c)[2], const bf16* DOt,
                                         const bf16* Ks, const bf16* Vs,
                                         int key0, float (&dq)[32]) {
  float ds[NC / 2];
  dp_chunk<NC>(ds, DOt, Vs, key0);
#pragma unroll
  for (int i = 0; i < NC / 2; ++i)
    ds[i] = p[OFF + i] * (ds[i] - c[(i >> 1) & 1]);
  uint32_t a[NC / 4];
  acc_to_a<NC / 2>(a, ds);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NC / 16; ++kk)
    sm90::Wgmma<kBHd, 1>::rs(dq, a + 4 * kk,
                             desc_mnmajor<kBHd, 64>(Ks, key0 / 16 + kk), 1);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(a);
  sm90::fence_regs(dq);
}

// The query pass of one 64-query tile (Qt, DOt) against N1 + N2 keys (Ks,
// Vs; N1 64 or 128, N2 0, 80 or 128): dq into rows row0.. of dqkv (tile
// rows < valid_rows), the tile's m and c into Mrow, Crow, and its scaled
// operands bf16(q·scale·inv_l), bf16(do·inv_l) into QSt, DOSt (0 on rows
// past valid_rows), fenced for the tensor cores. valid(h, key) is false for
// keys outside the row's sequence (p = 0 exactly).
template <int N1, int N2, class Valid>
__device__ __forceinline__ void query_pass(
    const bf16* Qt, const bf16* DOt, const bf16* Ks, const bf16* Vs,
    bf16* QSt, bf16* DOSt, float* Mrow, float* Crow, int valid_rows,
    float scale, Valid valid, bf16* dqkv, size_t row0, size_t ld, int col) {
  static_assert((N1 == 64 || N1 == 128) && (N2 == 0 || N2 == 80 || N2 == 128),
                "key chunks");
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int t = lane & 3;
  float s1[N1 / 2];
  float s2[N2 > 0 ? N2 / 2 : 2];
  sm90::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kBHd / 16; ++ks)
    sm90::Wgmma<N1, 0>::ss(s1, desc_kmajor<kBHd, 64>(Qt, 0, ks),
                           desc_kmajor<kBHd, 64>(Ks, 0, ks), ks > 0);
  if constexpr (N2 > 0) {
#pragma unroll
    for (int ks = 0; ks < kBHd / 16; ++ks)
      sm90::Wgmma<N2, 0>::ss(s2, desc_kmajor<kBHd, 64>(Qt, 0, ks),
                             desc_kmajor<kBHd, 64>(Ks, N1, ks), ks > 0);
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(s1);
  sm90::fence_regs(s2);

  const float neg = neg_inf();
  float mx[2] = {neg, neg}, l[2] = {0.0f, 0.0f};
  scale_and_max(s1, mx, 0, t, scale, valid);
  if constexpr (N2 > 0) scale_and_max(s2, mx, N1, t, scale, valid);
  quad_reduce(mx, true);
  exp_and_sum(s1, mx, l, 0, t, valid);  // s1, s2 hold p_un from here on
  if constexpr (N2 > 0) exp_and_sum(s2, mx, l, N1, t, valid);
  quad_reduce(l, false);
  const float inv[2] = {1.0f / l[0], 1.0f / l[1]};

  // c = sum(dp · p_un) · inv_l; dP in key chunks, computed again for ds
  float c[2] = {0.0f, 0.0f};
  c_chunk<64, 0>(s1, DOt, Vs, 0, c);
  if constexpr (N1 == 128) c_chunk<64, 32>(s1, DOt, Vs, 64, c);
  if constexpr (N2 == 80) c_chunk<80, 0>(s2, DOt, Vs, N1, c);
  if constexpr (N2 == 128) {
    c_chunk<64, 0>(s2, DOt, Vs, N1, c);
    c_chunk<64, 32>(s2, DOt, Vs, N1 + 64, c);
  }
  quad_reduce(c, false);
  c[0] *= inv[0];
  c[1] *= inv[1];

  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.0f;
  dq_chunk<64, 0>(s1, c, DOt, Ks, Vs, 0, dq);
  if constexpr (N1 == 128) dq_chunk<64, 32>(s1, c, DOt, Ks, Vs, 64, dq);
  if constexpr (N2 == 80) dq_chunk<80, 0>(s2, c, DOt, Ks, Vs, N1, dq);
  if constexpr (N2 == 128) {
    dq_chunk<64, 0>(s2, c, DOt, Ks, Vs, N1, dq);
    dq_chunk<64, 32>(s2, c, DOt, Ks, Vs, N1 + 64, dq);
  }
  const float fq[2] = {scale * inv[0], scale * inv[1]};
  store_tile(dq, fq, dqkv, row0, valid_rows, ld, col);

  float fs[2], fo[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + (lane >> 2) + 8 * h;
    const bool in = r < valid_rows;
    fs[h] = in ? fq[h] : 0.0f;
    fo[h] = in ? inv[h] : 0.0f;
    if (t == 0) {
      Mrow[r] = mx[h];
      Crow[r] = c[h];
    }
  }
  scale_tile_rows(QSt, Qt, fs);
  scale_tile_rows(DOSt, DOt, fo);
  wg::fence_proxy_async();  // the generic writes, before wgmma reads them
}

// The key pass of one 64-key tile (Kt, Vt) over nq 64-query tiles: dk and dv
// summed over the query tiles from the stored m, c and scaled operands, into
// rows row0.. (tile rows < limit) of dqkv at columns col_k, col_v.
// valid(h, q) is false where key row warp·16 + lane/4 + 8h and query q do
// not both exist in one sequence.
template <class Valid>
__device__ __forceinline__ void key_pass(
    const bf16* Kt, const bf16* Vt, const bf16* Qs, const bf16* DOs,
    const bf16* QSs, const bf16* DOSs, const float* Mrow, const float* Crow,
    int nq, float scale, Valid valid, bf16* dqkv, size_t row0, int limit,
    size_t ld, int col_k, int col_v) {
  const int t = threadIdx.x % 4;
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.0f;
  for (int qc = 0; qc < nq; ++qc) {
    const int o = qc * kBTileElems;
    float st[32], dpt[32];  // rows: keys; columns: queries
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBHd / 16; ++ks)
      sm90::Wgmma<64, 0>::ss(st, desc_kmajor<kBHd, 64>(Kt, 0, ks),
                             desc_kmajor<kBHd, 64>(Qs + o, 0, ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < kBHd / 16; ++ks)
      sm90::Wgmma<64, 0>::ss(dpt, desc_kmajor<kBHd, 64>(Vt, 0, ks),
                             desc_kmajor<kBHd, 64>(DOs + o, 0, ks), ks > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int q = qc * 64 + acc_col(i, t);
      const bool in = valid((i >> 1) & 1, q);
      const float p = in ? __expf(st[i] * scale - Mrow[q]) : 0.0f;
      st[i] = p;
      dpt[i] = p * (dpt[i] - Crow[q]);  // ds_un, rounded below
    }
    uint32_t ap[16], as[16];
    acc_to_a<32>(ap, st);
    acc_to_a<32>(as, dpt);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::Wgmma<kBHd, 1>::rs(dv, ap + 4 * kk,
                               desc_mnmajor<kBHd, 64>(DOSs + o, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::Wgmma<kBHd, 1>::rs(dk, as + 4 * kk,
                               desc_mnmajor<kBHd, 64>(QSs + o, kk), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(ap);
    sm90::fence_regs(as);
    sm90::fence_regs(dk);
    sm90::fence_regs(dv);
  }
  const float one[2] = {1.0f, 1.0f};
  store_tile(dk, one, dqkv, row0, limit, ld, col_k);
  store_tile(dv, one, dqkv, row0, limit, ld, col_v);
}

// Dense: grid (nseq, heads), two warpgroups. Every tile of the head is
// kRows rows in shared memory (zero-filled past L): Q, K, V, dO, then the
// scaled operands QS, DOS; the query pass gives warpgroup w query tiles
// w, w + 2, the key pass key tiles w, w + 2.
template <int N1, int N2>
struct DenseBwdCfg {
  static constexpr int kRows = (N1 + N2 + 63) / 64 * 64;
  static constexpr uint32_t kBytes = kRows * kBHd * 2;
  static constexpr size_t kSmem =
      1024 + 6 * (size_t)kBytes + 2 * kRows * sizeof(float) + 16;
};

template <int N1, int N2>
__global__ void __launch_bounds__(256, 1)
    attention_bwd_dense_kernel(const __grid_constant__ CUtensorMap qkv_map,
                               const __grid_constant__ CUtensorMap do_map,
                               bf16* __restrict__ dqkv, int L, int Da,
                               float scale) {
  constexpr int R = DenseBwdCfg<N1, N2>::kRows;
  extern __shared__ unsigned char bwd_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(flash_smem_base(bwd_smem));
  bf16* Ks = Qs + R * kBHd;
  bf16* Vs = Ks + R * kBHd;
  bf16* DOs = Vs + R * kBHd;
  bf16* QSs = DOs + R * kBHd;
  bf16* DOSs = QSs + R * kBHd;
  float* Mrow = reinterpret_cast<float*>(DOSs + R * kBHd);
  float* Crow = Mrow + R;
  uint64_t* bar = reinterpret_cast<uint64_t*>(Crow + R);
  const int seq = blockIdx.x, head = blockIdx.y;
  const int nq = (L + 63) / 64;
  if (threadIdx.x == 0) {
    sm90::mbar_init(bar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sm90::mbar_expect_tx(bar, (2 * nq + 2 * (R / 64)) * kBTile);
    for (int q = 0; q < nq; ++q) {
      sm90::tma_load_3d(Qs + q * kBTileElems, &qkv_map, bar, head * kBHd,
                        64 * q, seq);
      sm90::tma_load_3d(DOs + q * kBTileElems, &do_map, bar, head * kBHd,
                        64 * q, seq);
    }
    for (int k = 0; k < R / 64; ++k) {
      sm90::tma_load_3d(Ks + k * kBTileElems, &qkv_map, bar,
                        Da + head * kBHd, 64 * k, seq);
      sm90::tma_load_3d(Vs + k * kBTileElems, &qkv_map, bar,
                        2 * Da + head * kBHd, 64 * k, seq);
    }
  }
  sm90::mbar_wait(bar, 0);
  const int wgi = threadIdx.x / 128;
  const size_t ld = 3 * (size_t)Da;
  const size_t row0 = (size_t)seq * L;
  auto key_in = [L](int, int col) { return col < L; };
  for (int qt = wgi; qt < nq; qt += 2) {
    const int o = qt * kBTileElems;
    query_pass<N1, N2>(Qs + o, DOs + o, Ks, Vs, QSs + o, DOSs + o,
                       Mrow + 64 * qt, Crow + 64 * qt, L - 64 * qt, scale,
                       key_in, dqkv, row0 + 64 * qt, ld, head * kBHd);
  }
  __syncthreads();  // every tile's m, c, QS and DOS
  const int rbase = (threadIdx.x % 128) / 32 * 16 + (threadIdx.x % 32) / 4;
  for (int kt = wgi; kt < nq; kt += 2) {
    const int k0 = 64 * kt;
    auto both_in = [L, k0, rbase](int h, int q) {
      return q < L && k0 + rbase + 8 * h < L;
    };
    key_pass(Ks + kt * kBTileElems, Vs + kt * kBTileElems, Qs, DOs, QSs,
             DOSs, Mrow, Crow, nq, scale, both_in, dqkv, row0 + k0, L - k0,
             ld, Da + head * kBHd, 2 * Da + head * kBHd);
  }
}

// Packed: grid (ceil(rows / 128), heads), two warpgroups, each one 64-row
// tile of 64 / L whole sequences with its own Q, K, V, dO, QS and DOS; keys
// of another sequence are masked in both passes.
constexpr size_t kPackedBwdSmem = 1024 + 12 * (size_t)kBTile + 4 * 64 * 4 + 16;

__global__ void __launch_bounds__(256)
    attention_bwd_packed_kernel(const __grid_constant__ CUtensorMap qkv_map,
                                const __grid_constant__ CUtensorMap do_map,
                                bf16* __restrict__ dqkv, int rows, int L,
                                int Da, float scale) {
  extern __shared__ unsigned char bwd_smem[];
  bf16* tiles = reinterpret_cast<bf16*>(flash_smem_base(bwd_smem));
  float* stats = reinterpret_cast<float*>(tiles + 12 * kBTileElems);
  uint64_t* bar = reinterpret_cast<uint64_t*>(stats + 4 * 64);
  const int r0 = blockIdx.x * 128, head = blockIdx.y;
  if (threadIdx.x == 0) {
    sm90::mbar_init(bar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sm90::mbar_expect_tx(bar, 8 * kBTile);
    for (int w = 0; w < 2; ++w) {
      bf16* T = tiles + 6 * w * kBTileElems;  // Q, K, V, dO, QS, DOS
      const int r = r0 + 64 * w;
      for (int part = 0; part < 3; ++part)
        sm90::tma_load_3d(T + part * kBTileElems, &qkv_map, bar,
                          part * Da + head * kBHd, r, 0);
      sm90::tma_load_3d(T + 3 * kBTileElems, &do_map, bar, head * kBHd, r, 0);
    }
  }
  const int wgi = threadIdx.x / 128;
  const int r = r0 + 64 * wgi;
  if (r >= rows) return;  // warpgroup 0 keeps the block alive
  sm90::mbar_wait(bar, 0);
  bf16* T = tiles + 6 * wgi * kBTileElems;
  bf16* QS = T + 4 * kBTileElems;
  bf16* DOS = QS + kBTileElems;
  float* Mrow = stats + 64 * wgi;
  float* Crow = stats + 128 + 64 * wgi;
  const int rbase = (threadIdx.x % 128) / 32 * 16 + (threadIdx.x % 32) / 4;
  // row (query, or key in the key pass) rbase + 8h and column col of the
  // tile lie in the same sequence
  auto same_seq = [rbase, L](int h, int col) {
    return (rbase + 8 * h) / L == col / L;
  };
  const size_t ld = 3 * (size_t)Da;
  query_pass<64, 0>(T, T + 3 * kBTileElems, T + kBTileElems,
                    T + 2 * kBTileElems, QS, DOS, Mrow, Crow, rows - r, scale,
                    same_seq, dqkv, r, ld, head * kBHd);
  sm90::bar_sync(1 + wgi, 128);  // this tile's m, c, QS and DOS
  key_pass(T + kBTileElems, T + 2 * kBTileElems, T, T + 3 * kBTileElems, QS,
           DOS, Mrow, Crow, 1, scale, same_seq, dqkv, r, rows - r, ld,
           Da + head * kBHd, 2 * Da + head * kBHd);
}

inline bool bwd_variant_fits(int variant, int L, int hd) {
  if (variant == kBwdPacked) return hd == kBHd && L >= 1 && 64 % L == 0;
  if (variant == kBwdDense) return hd == kBHd && L > 32 && L <= 256;
  if (variant == kBwdLong) return hd == kBHd && L > 256;
  return variant == kBwdGeneral && L >= 1 && hd >= 1;
}

inline size_t dense_bwd_smem(int L) {
  if (L <= 64) return DenseBwdCfg<64, 0>::kSmem;
  if (L <= 128) return DenseBwdCfg<128, 0>::kSmem;
  if (L <= 208) return DenseBwdCfg<128, 80>::kSmem;
  return DenseBwdCfg<128, 128>::kSmem;
}

template <int N1, int N2>
cudaError_t launch_dense_bwd(const bf16* qkv, const bf16* dout, bf16* dqkv,
                             int nseq, int L, int Da, int heads, float scale,
                             cudaStream_t st) {
  CUtensorMap qm, dm;
  if (!make_tensor_map_3d(&qm, qkv, nseq, L, 3 * Da, 64, kBHd) ||
      !make_tensor_map_3d(&dm, dout, nseq, L, Da, 64, kBHd))
    return cudaErrorInvalidValue;
  constexpr size_t smem = DenseBwdCfg<N1, N2>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dense_kernel<N1, N2>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attention_bwd_dense_kernel<N1, N2><<<dim3(nseq, heads), 256, smem, st>>>(
      qm, dm, dqkv, L, Da, scale);
  return cudaGetLastError();
}

// fp32 floats the long variant's two passes need (the row arrays, and the
// dk/dv partials where the query range is split); 0 for the others.
inline size_t long_bwd_floats(int rows, int L, int heads, int variant) {
  if (variant != kBwdLong) return 0;
  const int bh = rows / L * heads;
  return flash_bwd_row_floats(bh, L) + flash_bwd_scratch_floats(bh, L, L, kBHd);
}

// Long: B6's passes on slice bh = (sequence, head), in place in qkv, do,
// attn and dqkv; `work` holds long_bwd_floats.
cudaError_t launch_long_bwd(const bf16* qkv, const bf16* dout,
                            const bf16* attn, const float* lse, bf16* dqkv,
                            float* work, int nseq, int L, int Da, int heads,
                            float scale, cudaStream_t st) {
  const int W = 3 * Da;
  if (attn == nullptr || lse == nullptr) return cudaErrorInvalidValue;
  FlashBwdMaps m;  // q, k and v in qkv (their columns differ), o in attn
  auto mk = [&](CUtensorMap* map, int which, int rows) {
    const bool in_qkv = which == kBwdQ || which == kBwdK || which == kBwdV;
    const bf16* base = in_qkv ? qkv : which == kBwdO ? attn : dout;
    return make_tensor_map_3d(map, base, nseq, L, in_qkv ? W : Da, rows,
                              kBHd);
  };
  if (!flash_bwd_maps<kBHd>(m, mk)) return cudaErrorInvalidValue;
  const int bh = nseq * heads;
  const HeadLayout lay{heads, 0, Da, 2 * Da, W, W};
  return launch_flash_bwd<kBHd>(m, lse, work,
                                work + flash_bwd_row_floats(bh, L), dqkv,
                                dqkv + Da, dqkv + 2 * Da, bh, L, L, scale,
                                lay, st);
}

// dqkv from qkv and do through the attention backward `variant` (the long
// one also reads the forward's attn and lse, and `work`).
cudaError_t launch_attention_bwd(int variant, const bf16* qkv,
                                 const bf16* dout, const bf16* attn,
                                 const float* lse, float* work, bf16* dqkv,
                                 int rows, int L, int Da, int heads,
                                 float scale, cudaStream_t st) {
  const int hd = Da / heads;
  const int nseq = rows / L;
  if (variant == kBwdLong)
    return launch_long_bwd(qkv, dout, attn, lse, dqkv, work, nseq, L, Da,
                           heads, scale, st);
  if (variant == kBwdDense) {
    if (L <= 64)
      return launch_dense_bwd<64, 0>(qkv, dout, dqkv, nseq, L, Da, heads,
                                     scale, st);
    if (L <= 128)
      return launch_dense_bwd<128, 0>(qkv, dout, dqkv, nseq, L, Da, heads,
                                      scale, st);
    if (L <= 208)
      return launch_dense_bwd<128, 80>(qkv, dout, dqkv, nseq, L, Da, heads,
                                       scale, st);
    return launch_dense_bwd<128, 128>(qkv, dout, dqkv, nseq, L, Da, heads,
                                      scale, st);
  }
  cudaError_t err;
  if (variant == kBwdPacked) {
    CUtensorMap qm, dm;
    if (!make_tensor_map_3d(&qm, qkv, 1, rows, 3 * Da, 64, kBHd) ||
        !make_tensor_map_3d(&dm, dout, 1, rows, Da, 64, kBHd))
      return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(attention_bwd_packed_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kPackedBwdSmem);
    if (err != cudaSuccess) return err;
    attention_bwd_packed_kernel<<<dim3((rows + 127) / 128, heads), 256,
                                  kPackedBwdSmem, st>>>(qm, dm, dqkv, rows, L,
                                                        Da, scale);
    return cudaGetLastError();
  }
  const size_t smem = small_bwd_smem_bytes(L, hd);
  err = cudaFuncSetAttribute(attention_bwd_small_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((nseq + kSmallWarps - 1) / kSmallWarps, heads);
  attention_bwd_small_kernel<<<grid, kSmallWarps * 32, smem, st>>>(
      qkv, dout, dqkv, nseq, L, Da, hd, scale);
  return cudaGetLastError();
}

// fp32 scratch, in order: d_xn, the LayerNorm partials, the weight
// gradients' slices (when split), the long attention's work, then the chunk
// sums of the column sums.
struct MhsaBwdScratch {
  size_t d_xn, ln_w, ln_b, proj_slices, qkv_slices, attn_work, chunks;
  size_t total() const {
    return d_xn + ln_w + ln_b + proj_slices + qkv_slices + attn_work + chunks;
  }
  float* attn_work_at(float* base) const {
    return base + d_xn + ln_w + ln_b + proj_slices + qkv_slices;
  }
};

inline MhsaBwdScratch mhsa_bwd_scratch(int rows, int D, int Da, int Do,
                                       int slices_proj, int slices_qkv,
                                       int heads, int L, int variant) {
  const int ln_rows = bwd::ln_bwd_part_rows(rows);
  MhsaBwdScratch s;
  s.d_xn = (size_t)rows * D;
  s.ln_w = s.ln_b = (size_t)ln_rows * D;
  s.proj_slices = slices_proj > 1 ? (size_t)slices_proj * Do * Da : 0;
  s.qkv_slices = slices_qkv > 1 ? (size_t)slices_qkv * 3 * Da * D : 0;
  s.attn_work = long_bwd_floats(rows, L, heads, variant);
  s.chunks = bwd::chunk_floats(rows, Do) + bwd::chunk_floats(rows, 3 * Da) +
             2 * bwd::chunk_floats(ln_rows, D);
  return s;
}

inline bool shapes_fit(int rows, int D, int Da, int heads, int L,
                       int variant) {
  return rows >= 1 && heads >= 1 && L >= 1 && rows % L == 0 &&
         Da % heads == 0 && D % 8 == 0 && D <= 1024 && Da % 8 == 0 &&
         bwd_variant_fits(variant, L, Da / heads) &&
         (variant != kBwdGeneral ||
          small_bwd_smem_bytes(L, Da / heads) <= 232448);
}

// B3's attention backward and what follows it: dqkv, d_xn = dqkv · Wqkv,
// the LayerNorm backward (+ g_res) into dx and its partial rows; the sums of
// dbqkv, dln_w and dln_b join `sums`.
cudaError_t attention_core(const bf16* x, const bf16* qkv, const bf16* dout,
                           const bf16* attn, const float* lse,
                           const bf16* g_res, const bf16* ln_w,
                           const bf16* w_qkv, bf16* dqkv, float* scratch,
                           bf16* dx, float* dln_w, float* dln_b, float* dbqkv,
                           int rows, int D, int Da, int heads, int L,
                           int variant, float scale, float eps,
                           const MhsaBwdScratch& sz, bwd::SumPlan& sums,
                           cudaStream_t st) {
  float* d_xn = scratch;
  float* part_w = d_xn + sz.d_xn;
  float* part_b = part_w + sz.ln_w;
  cudaError_t err = launch_attention_bwd(variant, qkv, dout, attn, lse,
                                         sz.attn_work_at(scratch), dqkv, rows,
                                         L, Da, heads, scale, st);
  if (err != cudaSuccess) return err;
  // d_xn = dqkv · Wqkv: (rows, D), K = 3Da, the weight read N-major
  wg::Params p{};
  p.C = d_xn;
  p.M = rows;
  p.N = D;
  p.K = 3 * Da;
  err = wg::launch_gemm<128, 0, 1, wg::kF32>(dqkv, w_qkv, p, 1, st);
  if (err != cudaSuccess) return err;
  err = bwd::launch_ln_bwd(x, d_xn, ln_w, g_res, dx, part_w, part_b, rows, D,
                           eps, st);
  if (err != cudaSuccess) return err;
  const int ln_rows = bwd::ln_bwd_part_rows(rows);
  sums.add(dqkv, true, rows, 3 * Da, dbqkv);
  sums.add(part_w, false, ln_rows, D, dln_w);
  sums.add(part_b, false, ln_rows, D, dln_b);
  return cudaSuccess;
}

}  // namespace vt

extern "C" {

// The version of this library's C entry points, for a tool that calls
// another checkout's build: 2 since the long attention variant added the lse
// pointer, B3 alone's attn and the heads, length and variant of the scratch
// size. A library without this entry point is version 1.
// 3 since the whole backward's recompute mode added b_qkv and the flag.
int vt_mhsa_abi_version() { return 3; }

// Dynamic shared memory the attention backward's `variant` (0 the CUDA-core
// kernel, 1 packed, 2 dense, 3 long; the wrapper chooses) needs at (L, hd),
// or -1 when the variant does not take the shape. The wrapper refuses
// shapes above the card's 227 KB per block.
int vt_mhsa_bwd_smem_bytes(int seq_len, int head_dim, int variant) {
  if (!vt::bwd_variant_fits(variant, seq_len, head_dim)) return -1;
  if (variant == vt::kBwdPacked) return (int)vt::kPackedBwdSmem;
  if (variant == vt::kBwdDense) return (int)vt::dense_bwd_smem(seq_len);
  if (variant == vt::kBwdLong) {
    constexpr size_t dq = vt::DqCfg<vt::kBHd>::kSmem;
    constexpr size_t dkv = vt::DkvCfg<vt::kBHd>::kSmem;
    return (int)(dq > dkv ? dq : dkv);
  }
  return (int)vt::small_bwd_smem_bytes(seq_len, head_dim);
}

// fp32 floats of scratch both entry points below need, with dw_proj and
// dw_qkv split into slices_proj and slices_qkv row slices (1: not split),
// for `heads` heads, sequences of seq_len and the attention `variant`; -1
// above 2^31.
int vt_mhsa_bwd_scratch_floats(int rows, int D, int Da, int Do,
                               int slices_proj, int slices_qkv, int num_heads,
                               int seq_len, int variant) {
  if (num_heads < 1 || seq_len < 1) return -1;
  const size_t n = vt::mhsa_bwd_scratch(rows, D, Da, Do, slices_proj,
                                        slices_qkv, num_heads, seq_len,
                                        variant).total();
  return n > 0x7fffffffu ? -1 : (int)n;
}

// fp32 floats of the work vt_mhsa_attention_bwd needs: the long variant's
// row arrays and scratch, 0 for the others; -1 above 2^31.
int vt_mhsa_attention_bwd_floats(int rows, int num_heads, int seq_len,
                                 int variant) {
  if (num_heads < 1 || seq_len < 1 || rows % seq_len) return -1;
  const size_t n = vt::long_bwd_floats(rows, seq_len, num_heads, variant);
  return n > 0x7fffffffu ? -1 : (int)n;
}

// B3's attention stage alone: dqkv (rows, 3Da) bf16 from qkv (rows, 3Da)
// and dout (rows, Da), with the forward's attn (rows, Da) and lse (nseq,
// heads, seq_len) fp32 for the long variant (else may be null) and `work`
// as sized above; the first stage of vt_mhsa_attn_bwd, to time the stage on
// its own.
int vt_mhsa_attention_bwd(const void* qkv, const void* dout, const void* attn,
                          const void* lse, void* work, void* dqkv, int rows,
                          int Da, int num_heads, int seq_len, int variant,
                          float scale, void* stream) {
  using vt::bf16;
  if (rows < 1 || num_heads < 1 || seq_len < 1 || rows % seq_len ||
      Da % num_heads ||
      !vt::bwd_variant_fits(variant, seq_len, Da / num_heads))
    return cudaErrorInvalidValue;
  return vt::launch_attention_bwd(
      variant, static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
      static_cast<const bf16*>(attn), static_cast<const float*>(lse),
      static_cast<float*>(work), static_cast<bf16*>(dqkv), rows, seq_len, Da,
      num_heads, scale, static_cast<cudaStream_t>(stream));
}

// B3 alone, from do: x (rows, D), qkv (rows, 3Da), dout (rows, Da), the
// forward's attn (rows, Da) and lse (nseq, heads, seq_len) fp32 (read by the
// long variant only; else may be null), g_res (rows, D) or null (no
// residual); ln_w (D), w_qkv (3Da, D) in (out, in) layout. dqkv (rows, 3Da)
// bf16 and `scratch` (vt_mhsa_bwd_scratch_floats with Do 8 and one slice)
// are caller-allocated. Outputs: dx (rows, D) bf16; dln_w, dln_b (D) and
// dbqkv (3Da) fp32.
int vt_mhsa_attn_bwd(const void* x, const void* qkv, const void* dout,
                     const void* attn, const void* lse, const void* g_res,
                     const void* ln_w, const void* w_qkv,
                     void* dqkv, void* scratch, void* dx, void* dln_w,
                     void* dln_b, void* dbqkv, int rows, int D, int Da,
                     int num_heads, int seq_len, int variant, float scale,
                     float ln_eps, void* stream) {
  using vt::bf16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!vt::shapes_fit(rows, D, Da, num_heads, seq_len, variant))
    return cudaErrorInvalidValue;
  const vt::MhsaBwdScratch sz = vt::mhsa_bwd_scratch(
      rows, D, Da, 8, 1, 1, num_heads, seq_len, variant);
  float* fs = static_cast<float*>(scratch);
  vt::bwd::SumPlan sums(fs + sz.total() - sz.chunks);
  const cudaError_t err = vt::attention_core(
      static_cast<const bf16*>(x), static_cast<const bf16*>(qkv),
      static_cast<const bf16*>(dout), static_cast<const bf16*>(attn),
      static_cast<const float*>(lse), static_cast<const bf16*>(g_res),
      static_cast<const bf16*>(ln_w), static_cast<const bf16*>(w_qkv),
      static_cast<bf16*>(dqkv), fs, static_cast<bf16*>(dx),
      static_cast<float*>(dln_w), static_cast<float*>(dln_b),
      static_cast<float*>(dbqkv), rows, D, Da, num_heads, seq_len, variant,
      scale, ln_eps, sz, sums, st);
  if (err != cudaSuccess) return err;
  return sums.run(st);
}

// The recompute mode's first stage alone: qkv (rows, 3Da) bf16 rebuilt
// from x (rows, D) as the whole call below rebuilds it, with ln_w, ln_b (D),
// w_qkv (3Da, D) and b_qkv (3Da); stats (rows float2) is caller-allocated.
// For a test to hold it against the forward's saved qkv, bit for bit.
int vt_mhsa_bwd_qkv(const void* x, const void* ln_w, const void* ln_b,
                    const void* w_qkv, const void* b_qkv, void* stats,
                    void* qkv, int rows, int D, int Da, float ln_eps,
                    void* stream) {
  using vt::bf16;
  if (rows < 1 || D % vt::wg::kBK || Da % 8) return cudaErrorInvalidValue;
  return vt::wg::launch_ln_linear(
      static_cast<const bf16*>(x), static_cast<const bf16*>(ln_w),
      static_cast<const bf16*>(ln_b), static_cast<const bf16*>(w_qkv),
      static_cast<const bf16*>(b_qkv), static_cast<float2*>(stats),
      static_cast<bf16*>(qkv), rows, D, 3 * Da, ln_eps,
      static_cast<cudaStream_t>(stream));
}

// The whole backward of the fused prenorm MHSA from the output gradient g
// (rows, Do): x (rows, D), the forward's qkv (rows, 3Da; null with
// recompute_qkv, which rebuilds it from x, ln_w, ln_b, w_qkv and b_qkv),
// attn (rows, Da) and lse (nseq, heads, seq_len fp32; the long variant's,
// else may be null), ln_w, ln_b (D), w_qkv (3Da, D), b_qkv (3Da; read in
// recompute mode only, else may be null), w_proj (Do, Da) in (out, in)
// layout.
// bf_scratch (rows · (D + 4Da) bf16: xn, do, dqkv; in recompute mode
// rows · (D + 7Da + 4): then the rebuilt qkv and its rows' LayerNorm
// statistics) and `scratch` (vt_mhsa_bwd_scratch_floats) are
// caller-allocated; dw_proj and dw_qkv are split into slices_proj /
// slices_qkv slices of per_proj / per_qkv 64-row k tiles. Outputs: dx
// (rows, D) bf16; fp32 dln_w, dln_b (D), dw_qkv (3Da, D), dbqkv (3Da),
// dw_proj (Do, Da), db_proj (Do).
int vt_fused_prenorm_mhsa_bwd(
    const void* g, const void* x, const void* qkv, const void* attn,
    const void* lse, const void* ln_w, const void* ln_b, const void* w_qkv,
    const void* b_qkv, const void* w_proj,
    void* bf_scratch, void* scratch, void* dx, void* dln_w, void* dln_b,
    void* dw_qkv, void* dbqkv, void* dw_proj, void* db_proj, int rows, int D,
    int Da, int Do, int num_heads, int seq_len, int variant, int slices_proj,
    int per_proj, int slices_qkv, int per_qkv, int add_residual,
    int recompute_qkv, float scale, float ln_eps, void* stream) {
  using vt::bf16;
  namespace wg = vt::wg;
  namespace bwd = vt::bwd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!vt::shapes_fit(rows, D, Da, num_heads, seq_len, variant) || Do < 8 ||
      Do % 8 || (add_residual && Do != D) ||
      !bwd::slices_cover(slices_proj, per_proj, rows) ||
      !bwd::slices_cover(slices_qkv, per_qkv, rows) ||
      (recompute_qkv ? b_qkv == nullptr || D % wg::kBK : qkv == nullptr))
    return cudaErrorInvalidValue;
  const bf16* gb = static_cast<const bf16*>(g);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* xn = static_cast<bf16*>(bf_scratch);
  bf16* dout = xn + (size_t)rows * D;
  bf16* dqkv = dout + (size_t)rows * Da;
  const bf16* qkv_in = static_cast<const bf16*>(qkv);
  cudaError_t err;
  if (recompute_qkv) {  // B1's qkv stage again (header)
    bf16* rebuilt = dqkv + (size_t)rows * 3 * Da;
    err = wg::launch_ln_linear(
        xb, static_cast<const bf16*>(ln_w), static_cast<const bf16*>(ln_b),
        static_cast<const bf16*>(w_qkv), static_cast<const bf16*>(b_qkv),
        reinterpret_cast<float2*>(rebuilt + (size_t)rows * 3 * Da), rebuilt,
        rows, D, 3 * Da, ln_eps, st);
    if (err != cudaSuccess) return err;
    qkv_in = rebuilt;
  }
  const vt::MhsaBwdScratch sz =
      vt::mhsa_bwd_scratch(rows, D, Da, Do, slices_proj, slices_qkv,
                           num_heads, seq_len, variant);
  float* fs = static_cast<float*>(scratch);
  float* proj_slices = fs + sz.d_xn + sz.ln_w + sz.ln_b;
  float* qkv_slices = proj_slices + sz.proj_slices;
  bwd::SumPlan sums(fs + sz.total() - sz.chunks);

  // dw_proj = gᵀ · attn: (Do, Da), K = rows, in slices_proj row slices
  wg::Params p{};
  p.C = slices_proj > 1 ? proj_slices : dw_proj;
  p.M = Do;
  p.N = Da;
  p.K = rows;
  p.ktiles_per_slice = per_proj;
  err = wg::launch_gemm<128, 1, 1, wg::kF32>(
      gb, static_cast<const bf16*>(attn), p, slices_proj, st);
  if (err != cudaSuccess) return err;
  // do = bf16(g · Wproj): (rows, Da), K = Do, the weight read N-major
  p = wg::Params{};
  p.C = dout;
  p.M = rows;
  p.N = Da;
  p.K = Do;
  err = wg::launch_gemm<128, 0, 1, wg::kPlain>(
      gb, static_cast<const bf16*>(w_proj), p, 1, st);
  if (err != cudaSuccess) return err;
  err = vt::attention_core(
      xb, qkv_in, dout,
      static_cast<const bf16*>(attn), static_cast<const float*>(lse),
      add_residual ? gb : nullptr,
      static_cast<const bf16*>(ln_w), static_cast<const bf16*>(w_qkv), dqkv,
      fs, static_cast<bf16*>(dx), static_cast<float*>(dln_w),
      static_cast<float*>(dln_b), static_cast<float*>(dbqkv), rows, D, Da,
      num_heads, seq_len, variant, scale, ln_eps, sz, sums, st);
  if (err != cudaSuccess) return err;
  // dw_qkv = dqkvᵀ · xn: (3Da, D), K = rows, xn the bf16 LayerNorm
  err = vt::launch_layernorm(xb, static_cast<const bf16*>(ln_w),
                             static_cast<const bf16*>(ln_b), xn, rows, D,
                             ln_eps, st);
  if (err != cudaSuccess) return err;
  p = wg::Params{};
  p.C = slices_qkv > 1 ? qkv_slices : dw_qkv;
  p.M = 3 * Da;
  p.N = D;
  p.K = rows;
  p.ktiles_per_slice = per_qkv;
  err = wg::launch_gemm<128, 1, 1, wg::kF32>(dqkv, xn, p, slices_qkv, st);
  if (err != cudaSuccess) return err;
  sums.add(gb, true, rows, Do, static_cast<float*>(db_proj));
  if (slices_proj > 1)
    sums.add(proj_slices, false, slices_proj, Do * Da,
             static_cast<float*>(dw_proj));
  if (slices_qkv > 1)
    sums.add(qkv_slices, false, slices_qkv, 3 * Da * D,
             static_cast<float*>(dw_qkv));
  return sums.run(st);
}

}  // extern "C"
