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

#include "bwd_common.cuh"
#include "layernorm.cuh"
#include "sm90_gemm.cuh"

namespace {

using vt::wg::bf16;
namespace bwd = vt::bwd;

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
  const int ln_rows = bwd::ln_bwd_part_rows(rows);
  s.db1_part = (size_t)part_rows * hidden;
  s.dw2_slices = slices2 > 1 ? (size_t)slices2 * Do * hidden : 0;
  s.dw1_slices = slices1 > 1 ? (size_t)slices1 * hidden * D : 0;
  s.ln_w = s.ln_b = (size_t)ln_rows * D;
  s.chunks = bwd::chunk_floats(part_rows, hidden) +
             bwd::chunk_floats(rows, Do) + 2 * bwd::chunk_floats(ln_rows, D);
  return s;
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
      !bwd::slices_cover(slices2, per2, rows) ||
      !bwd::slices_cover(slices1, per1, rows))
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
  err = bwd::launch_ln_bwd(xb, static_cast<const float*>(dxn),
                           static_cast<const bf16*>(ln_w), nullptr,
                           static_cast<bf16*>(dx), part_w, part_b, rows, D,
                           ln_eps, st);
  if (err != cudaSuccess) return err;

  // the column sums and the slices' sums, two ordered passes for all
  bwd::SumPlan sums(chunk);
  const int ln_rows = bwd::ln_bwd_part_rows(rows);
  sums.add(db1_part, false, wg::col_part_rows(rows), hidden,
           static_cast<float*>(db1));
  sums.add(gb, true, rows, Do, static_cast<float*>(db2));
  sums.add(part_w, false, ln_rows, D, static_cast<float*>(dln_w));
  sums.add(part_b, false, ln_rows, D, static_cast<float*>(dln_b));
  if (slices2 > 1)
    sums.add(dw2_slices, false, slices2, Do * hidden, static_cast<float*>(dw2));
  if (slices1 > 1)
    sums.add(dw1_slices, false, slices1, hidden * D, static_cast<float*>(dw1));
  return sums.run(st);
}

}  // extern "C"
