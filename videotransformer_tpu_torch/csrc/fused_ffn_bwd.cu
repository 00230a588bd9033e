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
// tensor-core rate; the rest is bandwidth. Design: the TPU kernel walks row
// blocks in order and adds each block's weight gradients into resident
// fp32 accumulators. Blocks on the card run in no order, so each weight
// gradient here is one GEMM whose K is the row count (gemm_tile.cuh with
// both operands read M-major through ldmatrix.trans, fp32 out): every
// element is summed by one thread in a fixed order. The bias and LayerNorm
// gradients are per-block partial rows (the dh GEMM's epilogue, the
// LayerNorm backward's warps) reduced by a second, ordered pass
// (reduce.cuh). No atomics: two runs give the same bits.
//
// Eight launches on the caller's stream, plus the column-sum passes:
// LayerNorm (xn), dh GEMM with the GELU-backward epilogue (writes bf16
// dh_pre, h and the db1 partials), dW2, dW1, dxn, LayerNorm backward. This
// first version writes xn, h and dh_pre (2·M·hidden + M·D bf16) and the fp32
// dxn to device memory where the TPU kernel kept them in VMEM.

#include "gemm_tile.cuh"
#include "layernorm.cuh"
#include "reduce.cuh"

namespace {

// fp32 scratch: db1 partials, then the column-sum and LayerNorm partials.
struct FfnBwdScratch {
  size_t db1_part, colsum, ln_w, ln_b, ln_sum;
  size_t total() const { return db1_part + colsum + ln_w + ln_b + ln_sum; }
};

FfnBwdScratch ffn_bwd_scratch(int rows, int D, int hidden, int Do) {
  FfnBwdScratch s;
  const int ln_rows = vt::layernorm_bwd_part_rows(rows);
  s.db1_part = (size_t)vt::gelu_bwd_part_rows(rows) * hidden;
  s.colsum = vt::colsum_scratch(vt::gelu_bwd_part_rows(rows), hidden);
  const size_t g_sum = vt::colsum_scratch(rows, Do);
  if (g_sum > s.colsum) s.colsum = g_sum;
  s.ln_w = s.ln_b = (size_t)ln_rows * D;
  s.ln_sum = vt::colsum_scratch(ln_rows, D);
  return s;
}

}  // namespace

extern "C" {

// fp32 floats of scratch vt_fused_prenorm_ffn_bwd needs.
int vt_ffn_bwd_scratch_floats(int rows, int D, int hidden, int Do) {
  return (int)ffn_bwd_scratch(rows, D, hidden, Do).total();
}

// x (rows, D), h_pre (rows, hidden), g (rows, Do) bf16; w1 (hidden, D),
// w2 (Do, hidden) in (out, in) layout. xn (rows, D), h and dh_pre (rows,
// hidden) bf16 and dxn (rows, D) fp32 are caller-allocated scratch, as is
// `scratch` (vt_ffn_bwd_scratch_floats). Outputs: dx (rows, D) bf16; fp32
// dln_w, dln_b (D), dw1 (hidden, D), db1 (hidden), dw2 (Do, hidden), db2 (Do).
int vt_fused_prenorm_ffn_bwd(const void* x, const void* h_pre, const void* g,
                             const void* ln_w, const void* ln_b,
                             const void* w1, const void* w2, void* xn,
                             void* h, void* dh_pre, void* dxn, void* scratch,
                             void* dx, void* dln_w, void* dln_b, void* dw1,
                             void* db1, void* dw2, void* db2, int rows, int D,
                             int hidden, int Do, float ln_eps, void* stream) {
  using vt::bf16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(g);
  bf16* xnb = static_cast<bf16*>(xn);
  bf16* hb = static_cast<bf16*>(h);
  bf16* dhb = static_cast<bf16*>(dh_pre);
  const FfnBwdScratch sz = ffn_bwd_scratch(rows, D, hidden, Do);
  float* db1_part = static_cast<float*>(scratch);
  float* colsum = db1_part + sz.db1_part;
  float* part_w = colsum + sz.colsum;
  float* part_b = part_w + sz.ln_w;
  float* ln_sum = part_b + sz.ln_b;

  cudaError_t err = vt::launch_layernorm(
      xb, static_cast<const bf16*>(ln_w), static_cast<const bf16*>(ln_b), xnb,
      rows, D, ln_eps, st);
  if (err != cudaSuccess) return err;
  // dh = g · W2 -> dh_pre = dh * gelu'(h_pre), h = gelu(h_pre), db1 partials
  vt::GemmParams p{gb, static_cast<const bf16*>(w2), nullptr,
                   static_cast<const bf16*>(h_pre), dhb, hb, db1_part,
                   rows, hidden, Do};
  err = vt::launch_gemm<vt::kGeluBwd, false, true>(p, st);
  if (err != cudaSuccess) return err;
  err = vt::launch_colsum(db1_part, colsum, static_cast<float*>(db1),
                          vt::gelu_bwd_part_rows(rows), hidden, st);
  if (err != cudaSuccess) return err;
  // dW2 = gᵀ · h: (Do, hidden), K = rows
  p = vt::GemmParams{gb, hb, nullptr, nullptr, dw2, nullptr, nullptr,
                     Do, hidden, rows};
  err = vt::launch_gemm<vt::kF32, true, true>(p, st);
  if (err != cudaSuccess) return err;
  err = vt::launch_colsum(gb, colsum, static_cast<float*>(db2), rows, Do, st);
  if (err != cudaSuccess) return err;
  // dW1 = dh_preᵀ · xn: (hidden, D), K = rows
  p = vt::GemmParams{dhb, xnb, nullptr, nullptr, dw1, nullptr, nullptr,
                     hidden, D, rows};
  err = vt::launch_gemm<vt::kF32, true, true>(p, st);
  if (err != cudaSuccess) return err;
  // dxn = dh_pre · W1: (rows, D), K = hidden
  p = vt::GemmParams{dhb, static_cast<const bf16*>(w1), nullptr, nullptr,
                     dxn, nullptr, nullptr, rows, D, hidden};
  err = vt::launch_gemm<vt::kF32, false, true>(p, st);
  if (err != cudaSuccess) return err;
  err = vt::launch_layernorm_bwd(xb, static_cast<const float*>(dxn),
                                 static_cast<const bf16*>(ln_w), nullptr,
                                 static_cast<bf16*>(dx), part_w, part_b, rows,
                                 D, ln_eps, st);
  if (err != cudaSuccess) return err;
  const int ln_rows = vt::layernorm_bwd_part_rows(rows);
  err = vt::launch_colsum(part_w, ln_sum, static_cast<float*>(dln_w), ln_rows,
                          D, st);
  if (err != cudaSuccess) return err;
  return vt::launch_colsum(part_b, ln_sum, static_cast<float*>(dln_b), ln_rows,
                           D, st);
}

}  // extern "C"
