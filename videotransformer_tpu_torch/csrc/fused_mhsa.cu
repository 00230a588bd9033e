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
// kernel's block-diagonal mode (divided temporal, L = 8). Each length-L
// block is simply its own sequence here; no masked scores are computed, so
// the TPU packing (_pack_group, _score_chunk) has no counterpart.
//
// Four launches on the caller's stream: LayerNorm, the qkv GEMM, attention,
// the projection GEMM. Unlike the TPU kernel, which kept them in VMEM, this
// first version writes xn (rows x D), qkv (rows x 3Da) and attn_out
// (rows x Da) to device memory: those round trips are the first thing to fuse.
// At the main shapes the two GEMMs carry ~90% of the FLOPs, so the kernel is
// bounded by the tensor-core rate of gemm_tile.cuh. The attention stage puts
// QKᵀ and PV on the tensor cores for sequences of 32 tokens and more (dense
// spatial, N = 197); the 8-token temporal sequences, whose products are too
// small for 16x16 tiles, run on the CUDA cores, 16 sequences per block.

#include "gemm_tile.cuh"
#include "layernorm.cuh"

namespace vt {

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

// ---- long sequences: QKᵀ and PV on the tensor cores ----------------------
//
// grid (nseq, heads); block kMmaWarps warps; one block per (sequence, head),
// for head_dim 64 and 32 <= L <= kMmaMaxKeys. K (row-major) and V
// (transposed) of the sequence sit in shared memory, padded with zeros to Lp
// (a multiple of 16) keys. Each warp takes 16-query tiles with mma.sync
// m16n8k16 (bf16 in, fp32 accumulate): the whole 16 x Lp score tile stays in
// registers, so the softmax sees every score of its row at once and keeps
// the TPU kernel's rounding points exactly: fp32 scores x scale, max over
// the row, p = exp(s - max) in fp32, the fp32 row sum, p rounded to bf16 as
// the A operand of the PV product (the accumulator layout of m16n8k16 is
// its A-operand layout), and O / sum rounded to bf16 at the end. Keys >= L
// get p = 0.

constexpr int kMmaWarps = 4;
constexpr int kMmaHd = 64;
constexpr int kMmaMaxKeys = 256;

__host__ __device__ inline int mma_pad(int L) { return (L + 15) / 16 * 16; }

__host__ __device__ inline size_t mma_smem_bytes(int L) {
  const int lp = mma_pad(L);
  return ((size_t)lp * (kMmaHd + 8) + (size_t)kMmaHd * (lp + 8)) *
         sizeof(bf16);
}

__global__ void __launch_bounds__(kMmaWarps * 32)
    attention_mma_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                         int L, int Da, float scale) {
  constexpr int HD = kMmaHd;
  constexpr int KLD = HD + 8;  // K row stride: 36 words, conflict-free
  constexpr int MAX_NT = kMmaMaxKeys / 8;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const int lp = mma_pad(L);
  const int vld = lp + 8;  // Vt row stride (keys)
  bf16* Ks = reinterpret_cast<bf16*>(mma_smem);  // [lp][KLD]
  bf16* Vt = Ks + lp * KLD;                      // [HD][vld]

  const int h = blockIdx.y;
  const size_t row0 = (size_t)blockIdx.x * L;
  const size_t ld = 3 * (size_t)Da;
  for (int idx = threadIdx.x; idx < lp * (HD / 8); idx += blockDim.x) {
    const int r = idx / (HD / 8);
    const int c = (idx % (HD / 8)) * 8;
    uint4 kv = make_uint4(0, 0, 0, 0);
    uint4 vv = make_uint4(0, 0, 0, 0);
    if (r < L) {
      const bf16* src = qkv + (row0 + r) * ld + h * HD + c;
      kv = *reinterpret_cast<const uint4*>(src + Da);
      vv = *reinterpret_cast<const uint4*>(src + 2 * Da);
    }
    *reinterpret_cast<uint4*>(Ks + r * KLD + c) = kv;
    const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
    for (int e = 0; e < 8; ++e) Vt[(c + e) * vld + r] = ve[e];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // fragment row (and row + 8)
  const int tig = lane & 3;  // fragment column pair
  const int nt_count = lp / 8;
  const float neg_inf = __int_as_float(0xff800000);

  for (int q0 = warp * 16; q0 < lp; q0 += kMmaWarps * 16) {
    uint32_t qa[HD / 16][4];  // A fragments of the 16-query tile
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = q0 + g + (i & 1) * 8;
        const int c = ks * 16 + tig * 2 + (i >> 1) * 8;
        qa[ks][i] = r < L ? ld_u32(qkv + (row0 + r) * ld + h * HD + c) : 0u;
      }

    float s[MAX_NT][4];
#pragma unroll
    for (int nt = 0; nt < MAX_NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
      if (nt < nt_count) {
#pragma unroll
        for (int ks = 0; ks < HD / 16; ++ks) {
          const bf16* kr = Ks + (nt * 8 + g) * KLD + ks * 16 + tig * 2;
          const uint32_t b[2] = {ld_u32(kr), ld_u32(kr + 8)};
          mma_16816(s[nt], qa[ks], b);
        }
      }
    }

    // rows g (elements 0, 1) and g + 8 (elements 2, 3); a quad shares a row
    float mx[2] = {neg_inf, neg_inf};
#pragma unroll
    for (int nt = 0; nt < MAX_NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = nt * 8 + tig * 2 + (e & 1);
        s[nt][e] *= scale;
        if (nt < nt_count && j < L) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
#pragma unroll
    for (int nt = 0; nt < MAX_NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = nt * 8 + tig * 2 + (e & 1);
        const float p = (nt < nt_count && j < L) ? expf(s[nt][e] - mx[e >> 1])
                                                 : 0.0f;
        sum[e >> 1] += p;  // the row sum is taken before p is rounded
        s[nt][e] = p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
    }

    float o[HD / 8][4];
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.0f;
#pragma unroll
    for (int kt = 0; kt < MAX_NT / 2; ++kt) {
      if (2 * kt < nt_count) {
        const uint32_t a[4] = {pack_bf16x2(s[2 * kt][0], s[2 * kt][1]),
                               pack_bf16x2(s[2 * kt][2], s[2 * kt][3]),
                               pack_bf16x2(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                               pack_bf16x2(s[2 * kt + 1][2], s[2 * kt + 1][3])};
#pragma unroll
        for (int dt = 0; dt < HD / 8; ++dt) {
          const bf16* vr = Vt + (dt * 8 + g) * vld + kt * 16 + tig * 2;
          const uint32_t b[2] = {ld_u32(vr), ld_u32(vr + 8)};
          mma_16816(o[dt], a, b);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = q0 + g + i * 8;
      if (r >= L) continue;
      bf16* dst = out + (row0 + r) * Da + h * HD + tig * 2;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8) =
            __floats2bfloat162_rn(o[dt][2 * i] / sum[i],
                                  o[dt][2 * i + 1] / sum[i]);
    }
  }
}

// The tensor-core kernel takes head_dim 64 and 32..kMmaMaxKeys tokens
// (dense spatial, N = 197); other shapes, and the 8-token temporal
// sequences, whose products are too small for 16-row tiles, go to the
// CUDA-core kernel above.
inline bool use_mma_attention(int L, int hd) {
  return hd == kMmaHd && L >= 32 && L <= kMmaMaxKeys;
}

}  // namespace vt

extern "C" {

// Dynamic shared memory the attention stage needs at (L, hd); the wrapper
// refuses shapes above the card's 227 KB per block.
int vt_mhsa_attention_smem_bytes(int seq_len, int head_dim) {
  if (vt::use_mma_attention(seq_len, head_dim))
    return (int)vt::mma_smem_bytes(seq_len);
  return (int)vt::attention_smem_bytes(seq_len, head_dim);
}

// x (rows, D) with rows = nseq * seq_len; weights in (out, in) layout:
// w_qkv (3Da, D), w_proj (Do, Da). xn/qkv/attn are caller-allocated scratch.
int vt_fused_prenorm_mhsa(const void* x, const void* ln_w, const void* ln_b,
                          const void* w_qkv, const void* b_qkv,
                          const void* w_proj, const void* b_proj, void* xn,
                          void* qkv, void* attn, void* out, int rows, int D,
                          int Da, int Do, int num_heads, int seq_len,
                          float scale, float ln_eps, int add_residual,
                          void* stream) {
  using vt::bf16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  cudaError_t err = vt::launch_layernorm(
      xb, static_cast<const bf16*>(ln_w), static_cast<const bf16*>(ln_b),
      static_cast<bf16*>(xn), rows, D, ln_eps, st);
  if (err != cudaSuccess) return err;
  vt::GemmParams p{static_cast<const bf16*>(xn),
                   static_cast<const bf16*>(w_qkv),
                   static_cast<const bf16*>(b_qkv), nullptr, qkv, nullptr,
                   nullptr, rows, 3 * Da, D};
  err = vt::launch_gemm<vt::kBias>(p, st);
  if (err != cudaSuccess) return err;

  const int hd = Da / num_heads;
  const int nseq = rows / seq_len;
  if (vt::use_mma_attention(seq_len, hd)) {
    const size_t smem = vt::mma_smem_bytes(seq_len);
    err = cudaFuncSetAttribute(vt::attention_mma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid(nseq, num_heads);
    vt::attention_mma_kernel<<<grid, vt::kMmaWarps * 32, smem, st>>>(
        static_cast<const bf16*>(qkv), static_cast<bf16*>(attn), seq_len, Da,
        scale);
  } else {
    const int spb = vt::seqs_per_block(seq_len);
    const size_t smem = vt::attention_smem_bytes(seq_len, hd);
    err = cudaFuncSetAttribute(vt::attention_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((nseq + spb - 1) / spb, num_heads);
    vt::attention_kernel<<<grid, vt::kAttnWarps * 32, smem, st>>>(
        static_cast<const bf16*>(qkv), static_cast<bf16*>(attn), nseq,
        seq_len, Da, hd, scale);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  p = vt::GemmParams{static_cast<const bf16*>(attn),
                     static_cast<const bf16*>(w_proj),
                     static_cast<const bf16*>(b_proj),
                     add_residual ? xb : nullptr, out, nullptr, nullptr, rows,
                     Do, Da};
  return add_residual ? vt::launch_gemm<vt::kBiasResidual>(p, st)
                      : vt::launch_gemm<vt::kBias>(p, st);
}

}  // extern "C"
