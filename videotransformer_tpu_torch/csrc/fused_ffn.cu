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
// Three launches on the caller's stream: LayerNorm, fc1 with the bias+GELU
// epilogue, fc2 with the bias epilogue (gemm_tile.cuh). For training the
// fc1 epilogue also stores the pre-GELU hidden h_pre = bf16(xn · W1ᵀ + b1)
// (the TPU kernel's with_hpre output, fused_ffn_pallas.py:77-78), which the
// backward (fused_ffn_bwd.cu) reads instead of recomputing fc1. This version
// writes xn (M x D) and the (M x hidden) GELU output to device memory, where
// the TPU kernel kept its hidden in VMEM: at M = 37656, hidden = 3072 that is
// 231 MB written and read again per call, the first thing to fuse. The two
// GEMMs (4·M·D·hidden FLOPs) bound it at the tensor-core rate.

#include "gemm_tile.cuh"
#include "layernorm.cuh"

extern "C" {

// x (rows, D); w1 (hidden, D), w2 (Do, hidden) in (out, in) layout; xn and h
// are caller-allocated scratch; h_pre (rows, hidden) is written when it is
// not null.
int vt_fused_prenorm_ffn(const void* x, const void* ln_w, const void* ln_b,
                         const void* w1, const void* b1, const void* w2,
                         const void* b2, void* xn, void* h, void* h_pre,
                         void* out, int rows, int D, int hidden, int Do,
                         float ln_eps, void* stream) {
  using vt::bf16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = vt::launch_layernorm(
      static_cast<const bf16*>(x), static_cast<const bf16*>(ln_w),
      static_cast<const bf16*>(ln_b), static_cast<bf16*>(xn), rows, D, ln_eps,
      st);
  if (err != cudaSuccess) return err;
  // fc1: h = gelu(xn · W1ᵀ + b1), and h_pre when training asks for it
  vt::GemmParams p{static_cast<const bf16*>(xn), static_cast<const bf16*>(w1),
                   static_cast<const bf16*>(b1), nullptr, h,
                   static_cast<bf16*>(h_pre), nullptr, rows, hidden, D};
  err = h_pre ? vt::launch_gemm<vt::kBiasGeluSave>(p, st)
              : vt::launch_gemm<vt::kBiasGelu>(p, st);
  if (err != cudaSuccess) return err;
  // fc2: out = h · W2ᵀ + b2
  p = vt::GemmParams{static_cast<const bf16*>(h), static_cast<const bf16*>(w2),
                     static_cast<const bf16*>(b2), nullptr, out, nullptr,
                     nullptr, rows, Do, hidden};
  return vt::launch_gemm<vt::kBias>(p, st);
}

}  // extern "C"
