// Fused prenorm FFN, backward, for Hopper (sm_90a).
//
// Replaces videotransformer_tpu/kernels/fused_ffn_pallas.py::_bwd_kernel
// (reached through _bwd / _vjp_bwd). From the forward's saved pre-GELU
// hidden h_pre (bf16) and the output gradient g, per row:
//
//   xn      = bf16(LayerNorm(x)),  h = bf16(gelu(h_pre))   recomputed
//   dh      = g · W2                   fp32 (bf16 g, as the TPU kernel feeds)
//   dh_pre  = dh * gelu'(h_pre)        fp32; db1 = sum of the fp32 dh_pre
//   dW2     = gᵀ · h,  db2 = sum of g  fp32
//   dW1     = bf16(dh_pre)ᵀ · xn       fp32
//   dxn     = bf16(dh_pre) · W1        fp32
//   dx      = LayerNorm backward of dxn (fp32), rounded to bf16;
//             dln_w, dln_b summed over the rows in fp32
//
// Bound: the four products (8·M·D·hidden FLOPs, twice the forward's) at the
// tensor-core rate; the rest is bandwidth. Design: the products run on the
// wgmma/TMA core (sm90_gemm.cuh), the weight gradients reading g, h, dh_pre
// and xn MN-major as they lie. The TPU kernel walks row blocks in order and
// adds each block's weight gradients into resident fp32 accumulators; blocks
// on the card run in no order, and one 128x128 output tile per block leaves
// most SMs idle at MViT's narrow widths (12 tiles at D = 192), so each
// weight gradient is split over the rows (K) into a fixed number of slices
// that the caller computes from the shape alone (fused_ffn.split_k). Each
// slice writes its fp32 partial tile; one ordered pass sums the slices in
// index order. The bias and LayerNorm gradients are per-warp partial rows
// (the dh product's epilogue, the LayerNorm backward's warps) summed the
// same way. No atomics: two runs give the same bits.
//
// Eight launches on the caller's stream: LayerNorm (xn), dh with the
// GELU-backward epilogue (writes bf16 dh_pre, h and the db1 partials), dW2,
// dW1, dxn, the LayerNorm backward, and two passes of column sums for db1,
// db2, dln_w, dln_b and the weight gradients' slices together. xn, h and
// dh_pre (bf16) and dxn (fp32) still go through device memory, where the TPU
// kernel kept them in VMEM.

#include "layernorm.cuh"
#include "sm90_gemm.cuh"

namespace {

using vt::wg::bf16;

constexpr int kSumThreads = 256;
constexpr int kSumChunk = 32;  // rows a thread adds in the first pass
constexpr int kMaxSlices = kSumChunk;

// out[N] = column sums of in[R][N] (bf16 or fp32): the first pass adds each
// kSumChunk-row chunk of a column top to bottom (into `out` when there is one
// chunk, else into part[chunk][N]); the second takes 32 columns a block:
// warp w adds the chunk sums w, w + 8, ... of its lane's column in order,
// then warp 0 adds the eight warps' sums in order.
struct SumJob {
  const void* in;
  float* out;
  float* part;
  int in_bf16, R, N, chunks;
};

constexpr int kMaxJobs = 6;
struct SumJobs {
  SumJob job[kMaxJobs];
  int n;
};

__host__ __device__ inline int col_blocks(const SumJob& j) {
  return (j.N + kSumThreads - 1) / kSumThreads;
}

__host__ __device__ inline int pass_blocks(const SumJob& j, int pass) {
  if (pass == 1) return j.chunks * col_blocks(j);
  return j.chunks > 1 ? (j.N + 31) / 32 : 0;
}

__global__ void __launch_bounds__(kSumThreads)
    colsum_jobs_kernel(const SumJobs jobs, int pass) {
  int b = blockIdx.x, k = 0;
  for (; k < jobs.n; ++k) {
    const int nb = pass_blocks(jobs.job[k], pass);
    if (b < nb) break;
    b -= nb;
  }
  if (k == jobs.n) return;
  const SumJob& j = jobs.job[k];
  float s = 0.0f;
  if (pass == 2) {
    __shared__ float warp_sums[kSumThreads / 32][32];
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int c = b * 32 + lane;
    if (c < j.N)
      for (int q = warp; q < j.chunks; q += kSumThreads / 32)
        s += j.part[(size_t)q * j.N + c];
    warp_sums[warp][lane] = s;
    __syncthreads();
    if (warp == 0 && c < j.N) {
      float t = 0.0f;
#pragma unroll
      for (int w = 0; w < kSumThreads / 32; ++w) t += warp_sums[w][lane];
      j.out[c] = t;
    }
    return;
  }
  const int cb = col_blocks(j);
  const int chunk = b / cb;
  const int c = (b % cb) * kSumThreads + threadIdx.x;
  if (c >= j.N) return;
  const int r1 = min(j.R, (chunk + 1) * kSumChunk);
#pragma unroll 8
  for (int r = chunk * kSumChunk; r < r1; ++r) {
    const size_t off = (size_t)r * j.N + c;
    s += j.in_bf16 ? __bfloat162float(static_cast<const bf16*>(j.in)[off])
                   : static_cast<const float*>(j.in)[off];
  }
  (j.chunks == 1 ? j.out : j.part + (size_t)chunk * j.N)[c] = s;
}

int chunks_of(int R) { return (R + kSumChunk - 1) / kSumChunk; }

// LayerNorm backward (fused_ffn_pallas.py:213-220), one warp a row:
//   xhat = (x - mean) * rstd, dxhat = dxn * w,
//   dx   = bf16(rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)))
// in fp32, with the statistics recomputed as layernorm.cuh computes them
// (the mean, then the mean of squared deviations). Lane l holds the 8-column
// chunks l, l + 32, ... (16-byte loads of x, 32-byte of dxn); each warp adds
// the weight and bias gradients of its kLnbRows rows in registers and writes
// them as one partial row.
constexpr int kLnbRows = 8;

int ln_bwd_part_rows(int rows) { return (rows + kLnbRows - 1) / kLnbRows; }

template <int CPL>  // 8-column chunks a lane: D <= 256 * CPL
__global__ void __launch_bounds__(256)
    ln_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ dxn,
                  const bf16* __restrict__ w, bf16* __restrict__ dx,
                  float* __restrict__ part_w, float* __restrict__ part_b,
                  int rows, int D, float eps) {
  const int gw = (blockIdx.x * 256 + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (gw * kLnbRows >= rows) return;  // whole warp leaves together
  float aw[CPL][8], ab[CPL][8], wv[CPL][8];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int col = (lane + 32 * c) * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) aw[c][e] = ab[c][e] = wv[c][e] = 0.0f;
    if (col < D) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(w + col));
      const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(b2[e]);
        wv[c][2 * e] = f.x;
        wv[c][2 * e + 1] = f.y;
      }
    }
  }
  for (int rr = 0; rr < kLnbRows; ++rr) {
    const int row = gw * kLnbRows + rr;
    if (row >= rows) break;
    float xv[CPL][8], dv[CPL][8];
    float sx = 0.0f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int col = (lane + 32 * c) * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) xv[c][e] = dv[c][e] = 0.0f;
      if (col < D) {
        const size_t off = (size_t)row * D + col;
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(x + off));
        const float4 d0 = __ldg(reinterpret_cast<const float4*>(dxn + off));
        const float4 d1 = __ldg(reinterpret_cast<const float4*>(dxn + off + 4));
        const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(b2[e]);
          xv[c][2 * e] = f.x;
          xv[c][2 * e + 1] = f.y;
        }
        dv[c][0] = d0.x; dv[c][1] = d0.y; dv[c][2] = d0.z; dv[c][3] = d0.w;
        dv[c][4] = d1.x; dv[c][5] = d1.y; dv[c][6] = d1.z; dv[c][7] = d1.w;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) sx += xv[c][e];
    }
    const float mean = vt::warp_sum(sx) / D;
    float sq = 0.0f;
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      if ((lane + 32 * c) * 8 < D)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = xv[c][e] - mean;
          sq += d * d;
        }
    const float rstd = rsqrtf(vt::warp_sum(sq) / D + eps);
    float m1 = 0.0f, m2 = 0.0f;
#pragma unroll
    for (int c = 0; c < CPL; ++c)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        xv[c][e] = (xv[c][e] - mean) * rstd;  // xhat from here on
        aw[c][e] += dv[c][e] * xv[c][e];
        ab[c][e] += dv[c][e];
        dv[c][e] *= wv[c][e];  // dxhat from here on
        m1 += dv[c][e];
        m2 += dv[c][e] * xv[c][e];
      }
    m1 = vt::warp_sum(m1) / D;
    m2 = vt::warp_sum(m2) / D;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int col = (lane + 32 * c) * 8;
      if (col >= D) continue;
      uint4 u;
      __nv_bfloat162* b2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        b2[e] = __floats2bfloat162_rn(
            rstd * (dv[c][2 * e] - m1 - xv[c][2 * e] * m2),
            rstd * (dv[c][2 * e + 1] - m1 - xv[c][2 * e + 1] * m2));
      *reinterpret_cast<uint4*>(dx + (size_t)row * D + col) = u;
    }
  }
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int col = (lane + 32 * c) * 8;
    if (col >= D) continue;
    float* pw = part_w + (size_t)gw * D + col;
    float* pb = part_b + (size_t)gw * D + col;
#pragma unroll
    for (int e = 0; e < 8; e += 4) {
      *reinterpret_cast<float4*>(pw + e) =
          make_float4(aw[c][e], aw[c][e + 1], aw[c][e + 2], aw[c][e + 3]);
      *reinterpret_cast<float4*>(pb + e) =
          make_float4(ab[c][e], ab[c][e + 1], ab[c][e + 2], ab[c][e + 3]);
    }
  }
}

cudaError_t launch_ln_bwd(const bf16* x, const float* dxn, const bf16* w,
                          bf16* dx, float* part_w, float* part_b, int rows,
                          int D, float eps, cudaStream_t st) {
  const int blocks = (ln_bwd_part_rows(rows) + 7) / 8;
  if (D % 8 || D > 1024) return cudaErrorInvalidValue;
  if (D <= 256)
    ln_bwd_kernel<1><<<blocks, 256, 0, st>>>(x, dxn, w, dx, part_w, part_b,
                                             rows, D, eps);
  else if (D <= 512)
    ln_bwd_kernel<2><<<blocks, 256, 0, st>>>(x, dxn, w, dx, part_w, part_b,
                                             rows, D, eps);
  else if (D <= 768)
    ln_bwd_kernel<3><<<blocks, 256, 0, st>>>(x, dxn, w, dx, part_w, part_b,
                                             rows, D, eps);
  else
    ln_bwd_kernel<4><<<blocks, 256, 0, st>>>(x, dxn, w, dx, part_w, part_b,
                                             rows, D, eps);
  return cudaGetLastError();
}

// fp32 scratch, in order: db1 partials, the weight gradients' slices (when
// split), the LayerNorm partials, then the chunk sums of the column sums.
struct FfnBwdScratch {
  size_t db1_part, dw2_slices, dw1_slices, ln_w, ln_b, chunks;
  size_t total() const {
    return db1_part + dw2_slices + dw1_slices + ln_w + ln_b + chunks;
  }
};

FfnBwdScratch ffn_bwd_scratch(int rows, int D, int hidden, int Do,
                              int slices2, int slices1) {
  FfnBwdScratch s;
  const int part_rows = vt::wg::col_part_rows(rows);
  const int ln_rows = ln_bwd_part_rows(rows);
  s.db1_part = (size_t)part_rows * hidden;
  s.dw2_slices = slices2 > 1 ? (size_t)slices2 * Do * hidden : 0;
  s.dw1_slices = slices1 > 1 ? (size_t)slices1 * hidden * D : 0;
  s.ln_w = s.ln_b = (size_t)ln_rows * D;
  auto chunk_part = [](int R, int N) {
    return chunks_of(R) > 1 ? (size_t)chunks_of(R) * N : 0;
  };
  s.chunks = chunk_part(part_rows, hidden) + chunk_part(rows, Do) +
             2 * chunk_part(ln_rows, D);
  return s;
}

bool slices_cover(int slices, int per, int K) {
  const int ktiles = (K + vt::wg::kBK - 1) / vt::wg::kBK;
  return slices >= 1 && slices <= kMaxSlices && per >= 1 &&
         (long long)slices * per >= ktiles &&
         (long long)(slices - 1) * per < ktiles;
}

}  // namespace

extern "C" {

// fp32 floats of scratch vt_fused_prenorm_ffn_bwd needs, with dW2 and dW1
// split into slices2 and slices1 row slices (1: not split); -1 above 2^31.
int vt_ffn_bwd_scratch_floats(int rows, int D, int hidden, int Do,
                              int slices2, int slices1) {
  const size_t n =
      ffn_bwd_scratch(rows, D, hidden, Do, slices2, slices1).total();
  return n > 0x7fffffffu ? -1 : (int)n;
}

// x (rows, D), h_pre (rows, hidden), g (rows, Do) bf16; w1 (hidden, D),
// w2 (Do, hidden) in (out, in) layout. xn (rows, D), h and dh_pre (rows,
// hidden) bf16 and dxn (rows, D) fp32 are caller-allocated scratch, as is
// `scratch` (vt_ffn_bwd_scratch_floats). dW2 and dW1 are split into
// slices2 / slices1 slices of per2 / per1 64-row k tiles. Outputs: dx
// (rows, D) bf16; fp32 dln_w, dln_b (D), dw1 (hidden, D), db1 (hidden), dw2
// (Do, hidden), db2 (Do).
int vt_fused_prenorm_ffn_bwd(const void* x, const void* h_pre, const void* g,
                             const void* ln_w, const void* ln_b,
                             const void* w1, const void* w2, void* xn,
                             void* h, void* dh_pre, void* dxn, void* scratch,
                             void* dx, void* dln_w, void* dln_b, void* dw1,
                             void* db1, void* dw2, void* db2, int rows, int D,
                             int hidden, int Do, int slices2, int per2,
                             int slices1, int per1, float ln_eps,
                             void* stream) {
  namespace wg = vt::wg;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 1 || D % 64 || hidden % 64 || Do % 8 || Do < 8 ||
      !slices_cover(slices2, per2, rows) || !slices_cover(slices1, per1, rows))
    return cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(g);
  bf16* xnb = static_cast<bf16*>(xn);
  bf16* hb = static_cast<bf16*>(h);
  bf16* dhb = static_cast<bf16*>(dh_pre);
  const FfnBwdScratch sz =
      ffn_bwd_scratch(rows, D, hidden, Do, slices2, slices1);
  float* db1_part = static_cast<float*>(scratch);
  float* dw2_slices = db1_part + sz.db1_part;
  float* dw1_slices = dw2_slices + sz.dw2_slices;
  float* part_w = dw1_slices + sz.dw1_slices;
  float* part_b = part_w + sz.ln_w;
  float* chunk = part_b + sz.ln_b;

  cudaError_t err = vt::launch_layernorm(
      xb, static_cast<const bf16*>(ln_w), static_cast<const bf16*>(ln_b), xnb,
      rows, D, ln_eps, st);
  if (err != cudaSuccess) return err;
  // dh = g · W2 -> dh_pre = dh * gelu'(h_pre), h = gelu(h_pre), db1 partials
  wg::Params p{};
  p.aux_in = static_cast<const bf16*>(h_pre);
  p.C = dhb;
  p.aux_out = hb;
  p.col_part = db1_part;
  p.M = rows;
  p.N = hidden;
  p.K = Do;
  err = wg::launch_gemm<128, 0, 1, wg::kGeluBwd>(
      gb, static_cast<const bf16*>(w2), p, 1, st);
  if (err != cudaSuccess) return err;
  // dW2 = gᵀ · h: (Do, hidden), K = rows, in slices2 row slices
  p = wg::Params{};
  p.C = slices2 > 1 ? dw2_slices : dw2;
  p.M = Do;
  p.N = hidden;
  p.K = rows;
  p.ktiles_per_slice = per2;
  err = wg::launch_gemm<128, 1, 1, wg::kF32>(gb, hb, p, slices2, st);
  if (err != cudaSuccess) return err;
  // dW1 = dh_preᵀ · xn: (hidden, D), K = rows, in slices1 row slices
  p.C = slices1 > 1 ? dw1_slices : dw1;
  p.M = hidden;
  p.N = D;
  p.ktiles_per_slice = per1;
  err = wg::launch_gemm<128, 1, 1, wg::kF32>(dhb, xnb, p, slices1, st);
  if (err != cudaSuccess) return err;
  // dxn = dh_pre · W1: (rows, D), K = hidden
  p = wg::Params{};
  p.C = dxn;
  p.M = rows;
  p.N = D;
  p.K = hidden;
  err = wg::launch_gemm<128, 0, 1, wg::kF32>(
      dhb, static_cast<const bf16*>(w1), p, 1, st);
  if (err != cudaSuccess) return err;
  err = launch_ln_bwd(xb, static_cast<const float*>(dxn),
                      static_cast<const bf16*>(ln_w), static_cast<bf16*>(dx),
                      part_w, part_b, rows, D, ln_eps, st);
  if (err != cudaSuccess) return err;

  // the column sums and the slices' sums, two ordered passes for all
  SumJobs jobs{};
  auto add = [&](const void* in, bool is_bf16, int R, int N, void* out) {
    SumJob& j = jobs.job[jobs.n++];
    j.in = in;
    j.out = static_cast<float*>(out);
    j.in_bf16 = is_bf16;
    j.R = R;
    j.N = N;
    j.chunks = chunks_of(R);
    j.part = chunk;
    if (j.chunks > 1) chunk += (size_t)j.chunks * N;
  };
  const int ln_rows = ln_bwd_part_rows(rows);
  add(db1_part, false, wg::col_part_rows(rows), hidden, db1);
  add(gb, true, rows, Do, db2);
  add(part_w, false, ln_rows, D, dln_w);
  add(part_b, false, ln_rows, D, dln_b);
  if (slices2 > 1) add(dw2_slices, false, slices2, Do * hidden, dw2);
  if (slices1 > 1) add(dw1_slices, false, slices1, hidden * D, dw1);
  for (int pass = 1; pass <= 2; ++pass) {
    int blocks = 0;
    for (int k = 0; k < jobs.n; ++k) blocks += pass_blocks(jobs.job[k], pass);
    if (blocks == 0) continue;
    colsum_jobs_kernel<<<blocks, kSumThreads, 0, st>>>(jobs, pass);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // extern "C"
