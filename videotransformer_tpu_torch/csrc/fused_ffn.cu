// Fused prenorm FFN, forward, for Hopper (sm_90a).
//
// Replaces videotransformer_tpu/kernels/fused_ffn_pallas.py::_kernel (the
// forward body reached through _fwd / fused_prenorm_ffn). Per row:
//
//   xn  = bf16(LayerNorm(x) with fp32 statistics)
//   h   = bf16(gelu_erf(xn · W1ᵀ + b1))      fp32 accumulate, exact erff GELU
//   out = bf16(h · W2ᵀ + b2)                 fp32 accumulate
//
// The TPU kernel's A&S polynomial erf (_erf) exists only because Mosaic has
// no erf; CUDA's erff is exact to fp32 rounding, which is what nn.GELU means.
//
// Bound: the two products (4·M·D·hidden FLOPs) at the tensor-core rate.
// Design: three launches on the caller's stream. layernorm.cuh writes xn
// once (2·M·D bytes out and back, ~0.05 ms at the serving shape); fc1 and
// fc2 run on the wgmma/TMA core (sm90_gemm.cuh, ping-pong warpgroups on
// 128 x 128 tiles), fc1 with the bias + GELU epilogue applied to the fp32
// accumulator before its one rounding (kBiasGelu), fc2 with the bias
// (kBias). For training fc1's epilogue also stores the pre-GELU hidden
// h_pre = bf16(xn · W1ᵀ + b1) (kBiasGeluSave; the TPU kernel's with_hpre
// output, fused_ffn_pallas.py:77-78), which the backward (fused_ffn_bwd.cu)
// reads instead of recomputing fc1. The hidden h makes a round trip through
// device memory, where the TPU kernel kept it in VMEM: 231 MB written and
// read at M = 37656, hidden = 3072, ~0.14 ms against ~0.36 ms of products.

#include "layernorm.cuh"
#include "sm90_gemm.cuh"

namespace {

using vt::wg::bf16;
namespace wg = vt::wg;

// fc1 on the core: epilogue kBias, kBiasGelu or kBiasGeluSave.
template <int EPI>
cudaError_t fc1(const bf16* xn, const bf16* w1, const bf16* b1, bf16* h,
                bf16* h_pre, int rows, int D, int hidden, cudaStream_t st) {
  wg::Params p{};
  p.bias = b1;
  p.C = h;
  p.aux_out = h_pre;
  p.M = rows;
  p.N = hidden;
  p.K = D;
  return wg::launch_gemm<128, 0, 0, EPI>(xn, w1, p, 1, st);
}

}  // namespace

extern "C" {

// x (rows, D); w1 (hidden, D), w2 (Do, hidden) in (out, in) layout; xn and h
// are caller-allocated scratch; h_pre (rows, hidden) is written when it is
// not null.
int vt_fused_prenorm_ffn(const void* x, const void* ln_w, const void* ln_b,
                         const void* w1, const void* b1, const void* w2,
                         const void* b2, void* xn, void* h, void* h_pre,
                         void* out, int rows, int D, int hidden, int Do,
                         float ln_eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 1 || D % 64 || hidden % 64 || Do % 8) return cudaErrorInvalidValue;
  bf16* xnb = static_cast<bf16*>(xn);
  bf16* hb = static_cast<bf16*>(h);
  cudaError_t err = vt::launch_layernorm(
      static_cast<const bf16*>(x), static_cast<const bf16*>(ln_w),
      static_cast<const bf16*>(ln_b), xnb, rows, D, ln_eps, st);
  if (err != cudaSuccess) return err;
  // fc1: h = gelu(xn · W1ᵀ + b1), and h_pre when training asks for it
  const bf16* w1b = static_cast<const bf16*>(w1);
  const bf16* b1b = static_cast<const bf16*>(b1);
  err = h_pre ? fc1<wg::kBiasGeluSave>(xnb, w1b, b1b, hb,
                                       static_cast<bf16*>(h_pre), rows, D,
                                       hidden, st)
              : fc1<wg::kBiasGelu>(xnb, w1b, b1b, hb, nullptr, rows, D,
                                   hidden, st);
  if (err != cudaSuccess) return err;
  // fc2: out = h · W2ᵀ + b2
  wg::Params p{};
  p.bias = static_cast<const bf16*>(b2);
  p.C = out;
  p.M = rows;
  p.N = Do;
  p.K = hidden;
  return wg::launch_gemm<128, 0, 0, wg::kBias>(
      hb, static_cast<const bf16*>(w2), p, 1, st);
}

// fc1 alone, from a given xn, with its GELU epilogue (gelu = 1) or with the
// bias alone (gelu = 0): the price of the epilogue, for tools/fused_bench.py.
int vt_ffn_fc1_stage(const void* xn, const void* w1, const void* b1, void* h,
                     int rows, int D, int hidden, int gelu, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 1 || D % 64 || hidden % 64) return cudaErrorInvalidValue;
  const bf16* a = static_cast<const bf16*>(xn);
  const bf16* w = static_cast<const bf16*>(w1);
  const bf16* b = static_cast<const bf16*>(b1);
  bf16* out = static_cast<bf16*>(h);
  return gelu ? fc1<wg::kBiasGelu>(a, w, b, out, nullptr, rows, D, hidden, st)
              : fc1<wg::kBias>(a, w, b, out, nullptr, rows, D, hidden, st);
}

}  // extern "C"
