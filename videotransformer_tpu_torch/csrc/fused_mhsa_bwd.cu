// Fused prenorm multi-head self-attention, backward, for Hopper (sm_90a).
//
// Replaces videotransformer_tpu/kernels/fused_mhsa_pallas.py::_attn_bwd_kernel
// (reached through _attn_bwd / _vjp_bwd). From the forward's saved qkv
// (bf16, rows x 3Da), the gradient do of the pre-projection attention output
// and, with the residual, the output gradient g:
//
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
//
// The rounding points are the TPU kernel's (fused_mhsa_pallas.py:351-414).
// The projection gradients and d_wqkv stay outside, as they were XLA
// einsums outside the Pallas kernel (kernels/fused_mhsa.py).
//
// Bound: at the train shapes the d_xn GEMM (2·rows·3Da·D FLOPs) and the
// attention products (five per head) are tensor-core work; the LayerNorm
// backward and the column sums are bandwidth. Design:
// - Dense sequences (32 < L <= 256, head dim 64; the spatial N = 197): one
//   block per (sequence, head) holds q, k, v, do of the sequence in shared
//   memory. Phase 1, per 16-query tile and warp: the row max (one pass of
//   QKᵀ), then l and c (a second pass, with dP = dO·Vᵀ), then dq (a third,
//   with dS·K); the stats m, inv_l, c and the scaled operands
//   bf16(q·scale·inv_l), bf16(do·inv_l) stay in shared memory. Phase 2, per
//   16-key tile and warp: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ are recomputed from the
//   stored row stats, and dk, dv are summed over the query tiles in
//   registers. Every product is mma.sync m16n8k16; no score tile leaves the
//   registers, and no sum crosses blocks.
// - Short sequences (L <= 32: the temporal L = 8, or 9 with the cls token),
//   and any other shape whose tiles fit in shared memory: 8x8 products are
//   too small for 16-row tiles, so each warp takes one (sequence, head) on
//   the CUDA cores, with q, k, v, do and the L x L score and dP tiles in its
//   slice of shared memory.
// - dbqkv and the LayerNorm gradients are partial rows reduced by an
//   ordered second pass (reduce.cuh): no atomics, the same bits every run.
// This first version writes dqkv (bf16) and d_xn (fp32) to device memory
// where the TPU kernel kept them in VMEM.

#include "gemm_tile.cuh"
#include "layernorm.cuh"
#include "reduce.cuh"

namespace vt {

// ---- short sequences, CUDA cores ------------------------------------------

constexpr int kSmallWarps = 4;
constexpr int kSmallMaxL = 32;  // longer sequences at head dim 64: mma

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

// ---- dense sequences, tensor cores ----------------------------------------

constexpr int kMmaBwdWarps = 8;
constexpr int kMmaBwdHd = 64;
constexpr int kMmaBwdMaxL = 256;
constexpr int kMmaBwdLd = kMmaBwdHd + 8;  // padded row: 144 bytes

__host__ __device__ inline int bwd_pad(int L) { return (L + 15) / 16 * 16; }

// q, k, v, do, bf16(q·scale·inv_l), bf16(do·inv_l), and m, inv_l, c
__host__ __device__ inline size_t mma_bwd_smem_bytes(int L) {
  const size_t lp = bwd_pad(L);
  return 6 * lp * kMmaBwdLd * sizeof(bf16) + 3 * lp * sizeof(float);
}

// s (two n8 tiles: 16 keys) = q_tile · k_tileᵀ for 16 rows; qa the A
// fragments (4 k-steps of head dim), kbase the first key row in smem.
__device__ __forceinline__ void qk_tile16(float (*s)[4], uint32_t (*qa)[4],
                                          const bf16* kbase, int lane) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < kMmaBwdHd / 16; ++ks) {
    uint32_t b[4];
    load_b_nk(b, kbase + ks * 16, kMmaBwdLd, lane);
    mma_16816(s[0], qa[ks], b);
    mma_16816(s[1], qa[ks], b + 2);
  }
}

// acc (8 n8 tiles of head dim) += a (16 x 16) · B, B stored [k][d] from
// `base` (16 rows of the k index).
__device__ __forceinline__ void av_tile16(float (*acc)[4], const uint32_t* a,
                                          const bf16* base, int lane) {
#pragma unroll
  for (int dt = 0; dt < kMmaBwdHd / 16; ++dt) {
    uint32_t b[4];
    load_b_kn(b, base + dt * 16, kMmaBwdLd, lane);
    mma_16816(acc[2 * dt], a, b);
    mma_16816(acc[2 * dt + 1], a, b + 2);
  }
}

// grid (nseq, heads); block kMmaBwdWarps warps.
__global__ void __launch_bounds__(kMmaBwdWarps * 32, 1)
    attention_bwd_mma_kernel(const bf16* __restrict__ qkv,
                             const bf16* __restrict__ dout,
                             bf16* __restrict__ dqkv, int L, int Da,
                             float scale) {
  constexpr int HD = kMmaBwdHd;
  constexpr int LD = kMmaBwdLd;
  extern __shared__ __align__(16) unsigned char sm_mma[];
  const int lp = bwd_pad(L);
  bf16* Qs = reinterpret_cast<bf16*>(sm_mma);
  bf16* Ks = Qs + lp * LD;
  bf16* Vs = Ks + lp * LD;
  bf16* DOs = Vs + lp * LD;
  bf16* QSs = DOs + lp * LD;   // bf16(q · scale · inv_l)
  bf16* DOSs = QSs + lp * LD;  // bf16(do · inv_l)
  float* Mrow = reinterpret_cast<float*>(DOSs + lp * LD);
  float* Inv = Mrow + lp;
  float* Crow = Inv + lp;

  const int h = blockIdx.y;
  const size_t row0 = (size_t)blockIdx.x * L;
  const size_t ld = 3 * (size_t)Da;
  for (int idx = threadIdx.x; idx < lp * (HD / 8); idx += blockDim.x) {
    const int r = idx / (HD / 8);
    const int c = (idx % (HD / 8)) * 8;
    uint4 q = make_uint4(0, 0, 0, 0), k = q, v = q, o = q;
    if (r < L) {
      const bf16* src = qkv + (row0 + r) * ld + h * HD + c;
      q = *reinterpret_cast<const uint4*>(src);
      k = *reinterpret_cast<const uint4*>(src + Da);
      v = *reinterpret_cast<const uint4*>(src + 2 * Da);
      o = *reinterpret_cast<const uint4*>(dout + (row0 + r) * Da + h * HD + c);
    }
    *reinterpret_cast<uint4*>(Qs + r * LD + c) = q;
    *reinterpret_cast<uint4*>(Ks + r * LD + c) = k;
    *reinterpret_cast<uint4*>(Vs + r * LD + c) = v;
    *reinterpret_cast<uint4*>(DOs + r * LD + c) = o;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // fragment row (and row + 8)
  const int tig = lane & 3;  // fragment column pair
  const int tiles = lp / 16;
  const float neg_inf = __int_as_float(0xff800000);

  // ---- phase 1: per query tile, the row stats and dq
  for (int qt = warp; qt < tiles; qt += kMmaBwdWarps) {
    const int q0 = qt * 16;
    uint32_t qa[HD / 16][4], da[HD / 16][4];
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      load_a_mk(qa[ks], Qs + q0 * LD + ks * 16, LD, lane);
      load_a_mk(da[ks], DOs + q0 * LD + ks * 16, LD, lane);
    }
    float mx[2] = {neg_inf, neg_inf};
    for (int k0 = 0; k0 < lp; k0 += 16) {
      float s[2][4];
      qk_tile16(s, qa, Ks + k0 * LD, lane);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + nt * 8 + tig * 2 + (e & 1) < L)
            mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e] * scale);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    float l[2] = {0.0f, 0.0f}, cs[2] = {0.0f, 0.0f};
    for (int k0 = 0; k0 < lp; k0 += 16) {
      float s[2][4], dp[2][4];
      qk_tile16(s, qa, Ks + k0 * LD, lane);
      qk_tile16(dp, da, Vs + k0 * LD, lane);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool valid = k0 + nt * 8 + tig * 2 + (e & 1) < L;
          const float p = valid ? expf(s[nt][e] * scale - mx[e >> 1]) : 0.0f;
          l[e >> 1] += p;
          cs[e >> 1] += dp[nt][e] * p;
        }
    }
    float inv[2], c[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      cs[i] += __shfl_xor_sync(0xffffffffu, cs[i], 1);
      cs[i] += __shfl_xor_sync(0xffffffffu, cs[i], 2);
      inv[i] = 1.0f / l[i];
      c[i] = cs[i] * inv[i];
    }
    if (tig == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = q0 + g + i * 8;
        const bool valid = r < L;
        Mrow[r] = valid ? mx[i] : 0.0f;
        Inv[r] = valid ? inv[i] : 0.0f;
        Crow[r] = valid ? c[i] : 0.0f;
      }
    }
    __syncwarp();
    // the scaled operands of phase 2, for this tile's rows (zero past L)
    for (int idx = lane; idx < 16 * HD; idx += 32) {
      const int r = q0 + idx / HD, d = idx % HD;
      const float iv = Inv[r];
      QSs[r * LD + d] =
          __float2bfloat16(__bfloat162float(Qs[r * LD + d]) * (scale * iv));
      DOSs[r * LD + d] = __float2bfloat16(__bfloat162float(DOs[r * LD + d]) * iv);
    }
    // dq = (ds_un · k) · (scale · inv_l)
    float acc[HD / 8][4];
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.0f;
    for (int k0 = 0; k0 < lp; k0 += 16) {
      float s[2][4], dp[2][4];
      qk_tile16(s, qa, Ks + k0 * LD, lane);
      qk_tile16(dp, da, Vs + k0 * LD, lane);
      float ds[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool valid = k0 + nt * 8 + tig * 2 + (e & 1) < L;
          const float p = valid ? expf(s[nt][e] * scale - mx[e >> 1]) : 0.0f;
          ds[nt][e] = p * (dp[nt][e] - c[e >> 1]);
        }
      const uint32_t a[4] = {pack_bf16x2(ds[0][0], ds[0][1]),
                             pack_bf16x2(ds[0][2], ds[0][3]),
                             pack_bf16x2(ds[1][0], ds[1][1]),
                             pack_bf16x2(ds[1][2], ds[1][3])};
      av_tile16(acc, a, Ks + k0 * LD, lane);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = q0 + g + i * 8;
      if (r >= L) continue;
      const float f = scale * inv[i];
      bf16* dst = dqkv + (row0 + r) * ld + h * HD + tig * 2;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8) =
            __floats2bfloat162_rn(acc[dt][2 * i] * f, acc[dt][2 * i + 1] * f);
    }
  }
  __syncthreads();

  // ---- phase 2: per key tile, dk and dv summed over the query tiles
  for (int kt = warp; kt < tiles; kt += kMmaBwdWarps) {
    const int k0 = kt * 16;
    uint32_t ka[HD / 16][4], va[HD / 16][4];
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      load_a_mk(ka[ks], Ks + k0 * LD + ks * 16, LD, lane);
      load_a_mk(va[ks], Vs + k0 * LD + ks * 16, LD, lane);
    }
    float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.0f;
    for (int q0 = 0; q0 < lp; q0 += 16) {
      float st[2][4], dpt[2][4];  // rows: keys; columns: queries
      qk_tile16(st, ka, Qs + q0 * LD, lane);
      qk_tile16(dpt, va, DOs + q0 * LD, lane);
      float pt[2][4], dst[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = q0 + nt * 8 + tig * 2 + (e & 1);
          const float p = q < L ? expf(st[nt][e] * scale - Mrow[q]) : 0.0f;
          pt[nt][e] = p;
          dst[nt][e] = p * (dpt[nt][e] - Crow[q]);
        }
      const uint32_t ap[4] = {pack_bf16x2(pt[0][0], pt[0][1]),
                              pack_bf16x2(pt[0][2], pt[0][3]),
                              pack_bf16x2(pt[1][0], pt[1][1]),
                              pack_bf16x2(pt[1][2], pt[1][3])};
      const uint32_t as[4] = {pack_bf16x2(dst[0][0], dst[0][1]),
                              pack_bf16x2(dst[0][2], dst[0][3]),
                              pack_bf16x2(dst[1][0], dst[1][1]),
                              pack_bf16x2(dst[1][2], dst[1][3])};
      av_tile16(dv, ap, DOSs + q0 * LD, lane);
      av_tile16(dk, as, QSs + q0 * LD, lane);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = k0 + g + i * 8;
      if (r >= L) continue;
      bf16* dst = dqkv + (row0 + r) * ld + h * HD + tig * 2;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        *reinterpret_cast<__nv_bfloat162*>(dst + Da + dt * 8) =
            __floats2bfloat162_rn(dk[dt][2 * i], dk[dt][2 * i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dst + 2 * Da + dt * 8) =
            __floats2bfloat162_rn(dv[dt][2 * i], dv[dt][2 * i + 1]);
      }
    }
  }
}

inline bool use_mma_bwd(int L, int hd) {
  return hd == kMmaBwdHd && L > kSmallMaxL && L <= kMmaBwdMaxL;
}

struct MhsaBwdScratch {
  size_t bias_sum, ln_w, ln_b, ln_sum;
  size_t total() const { return bias_sum + ln_w + ln_b + ln_sum; }
};

inline MhsaBwdScratch mhsa_bwd_scratch(int rows, int D, int Da) {
  const int ln_rows = layernorm_bwd_part_rows(rows);
  MhsaBwdScratch s;
  s.bias_sum = colsum_scratch(rows, 3 * Da);
  s.ln_w = s.ln_b = (size_t)ln_rows * D;
  s.ln_sum = colsum_scratch(ln_rows, D);
  return s;
}

}  // namespace vt

extern "C" {

// Dynamic shared memory the attention backward needs at (L, hd); the
// wrapper refuses shapes above the card's 227 KB per block.
int vt_mhsa_bwd_smem_bytes(int seq_len, int head_dim) {
  if (vt::use_mma_bwd(seq_len, head_dim))
    return (int)vt::mma_bwd_smem_bytes(seq_len);
  return (int)vt::small_bwd_smem_bytes(seq_len, head_dim);
}

// fp32 floats of scratch vt_fused_prenorm_mhsa_bwd needs.
int vt_mhsa_bwd_scratch_floats(int rows, int D, int Da) {
  return (int)vt::mhsa_bwd_scratch(rows, D, Da).total();
}

// x (rows, D), qkv (rows, 3Da), dout (rows, Da) = d(attention output),
// g_res (rows, D) or null (no residual); ln_w (D), w_qkv (3Da, D) in
// (out, in) layout. d_xn (rows, D) fp32 and `scratch`
// (vt_mhsa_bwd_scratch_floats) are caller-allocated. Outputs: dqkv
// (rows, 3Da) and dx (rows, D) bf16; dln_w, dln_b (D) and dbqkv (3Da) fp32.
int vt_fused_prenorm_mhsa_bwd(const void* x, const void* qkv, const void* dout,
                              const void* g_res, const void* ln_w,
                              const void* w_qkv, void* dqkv, void* d_xn,
                              void* scratch, void* dx, void* dln_w,
                              void* dln_b, void* dbqkv, int rows, int D,
                              int Da, int num_heads, int seq_len, float scale,
                              float ln_eps, void* stream) {
  using vt::bf16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hd = Da / num_heads;
  const int nseq = rows / seq_len;
  const bf16* qkvb = static_cast<const bf16*>(qkv);
  const bf16* dob = static_cast<const bf16*>(dout);
  bf16* dqkvb = static_cast<bf16*>(dqkv);
  cudaError_t err;
  if (vt::use_mma_bwd(seq_len, hd)) {
    const size_t smem = vt::mma_bwd_smem_bytes(seq_len);
    err = cudaFuncSetAttribute(vt::attention_bwd_mma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid(nseq, num_heads);
    vt::attention_bwd_mma_kernel<<<grid, vt::kMmaBwdWarps * 32, smem, st>>>(
        qkvb, dob, dqkvb, seq_len, Da, scale);
  } else {
    const size_t smem = vt::small_bwd_smem_bytes(seq_len, hd);
    err = cudaFuncSetAttribute(vt::attention_bwd_small_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((nseq + vt::kSmallWarps - 1) / vt::kSmallWarps, num_heads);
    vt::attention_bwd_small_kernel<<<grid, vt::kSmallWarps * 32, smem, st>>>(
        qkvb, dob, dqkvb, nseq, seq_len, Da, hd, scale);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const vt::MhsaBwdScratch sz = vt::mhsa_bwd_scratch(rows, D, Da);
  float* bias_sum = static_cast<float*>(scratch);
  float* part_w = bias_sum + sz.bias_sum;
  float* part_b = part_w + sz.ln_w;
  float* ln_sum = part_b + sz.ln_b;
  err = vt::launch_colsum(static_cast<const bf16*>(dqkvb), bias_sum,
                          static_cast<float*>(dbqkv), rows, 3 * Da, st);
  if (err != cudaSuccess) return err;
  // d_xn = dqkv · Wqkv: (rows, D), K = 3Da, the weight read N-major
  vt::GemmParams p{dqkvb, static_cast<const bf16*>(w_qkv), nullptr, nullptr,
                   d_xn, nullptr, nullptr, rows, D, 3 * Da};
  err = vt::launch_gemm<vt::kF32, false, true>(p, st);
  if (err != cudaSuccess) return err;
  err = vt::launch_layernorm_bwd(
      static_cast<const bf16*>(x), static_cast<const float*>(d_xn),
      static_cast<const bf16*>(ln_w), static_cast<const bf16*>(g_res),
      static_cast<bf16*>(dx), part_w, part_b, rows, D, ln_eps, st);
  if (err != cudaSuccess) return err;
  const int ln_rows = vt::layernorm_bwd_part_rows(rows);
  err = vt::launch_colsum(part_w, ln_sum, static_cast<float*>(dln_w), ln_rows,
                          D, st);
  if (err != cudaSuccess) return err;
  return vt::launch_colsum(part_b, ln_sum, static_cast<float*>(dln_b), ln_rows,
                           D, st);
}

}  // extern "C"
