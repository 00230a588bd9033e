"""Fused prenorm multi-head self-attention: LayerNorm -> qkv -> attention ->
proj [-> +x], forward only.

Port of ``videotransformer_tpu/kernels/fused_mhsa_pallas.py::_kernel``. On a
CUDA tensor ``fused_prenorm_mhsa`` launches the hand-written kernel in
``csrc/fused_mhsa.cu`` (bf16 only) or raises; on a CPU tensor it runs
``fused_prenorm_mhsa_reference``, the plain PyTorch version with the same
rounding order. There is no other branch.

Layouts: x is (B, N, D) as in the JAX package; weights are in nn.Linear's
(out, in) layout: w_qkv (3·Da, D), w_proj (Do, Da). ``block_diag=T`` (N
divisible by T) makes each length-T block of a sequence its own sequence,
which is what the TPU kernel's block-diagonal mask computes.
"""

import ctypes

import torch

from videotransformer_tpu_torch.kernels import _build
from videotransformer_tpu_torch.kernels._plain import layer_norm, linear_fp32

# Calls that reached the CUDA kernel (not the plain version).
LAUNCHES = 0

_MAX_SMEM = 232448  # bytes of shared memory one block may use on sm_90
_SIGNATURES = {
    "vt_fused_prenorm_mhsa": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "vt_mhsa_attention_smem_bytes": [ctypes.c_int, ctypes.c_int],
}


def _seq_len(N, block_diag):
    if block_diag and N % block_diag:
        raise ValueError(f"N={N} is not a multiple of block_diag={block_diag}")
    return block_diag or N


def fused_prenorm_mhsa_reference(x, ln_w, ln_b, w_qkv, b_qkv, w_proj, b_proj,
                                 num_heads, scale, ln_eps=1e-5,
                                 add_residual=True, block_diag=0):
    """Plain version, in the kernel's rounding order: fp32 LN statistics ->
    xn; fp32-accumulated qkv -> working type; fp32 scores × scale,
    max-subtract, exp, p rounded to the working type before the PV product,
    PV in fp32 divided by the fp32 row sum -> working type; fp32 projection
    + bias (+ x) -> working type."""
    B, N, D = x.shape
    dt = x.dtype
    Da = w_qkv.shape[0] // 3
    hd = Da // num_heads
    L = _seq_len(N, block_diag)
    xn = layer_norm(x, ln_w, ln_b, ln_eps)
    qkv = linear_fp32(xn, w_qkv, b_qkv).to(dt)
    qkv = qkv.reshape(B * N // L, L, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0].float(), qkv[1].float(), qkv[2].float()
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.matmul(p.to(dt).float(), v) / p.sum(-1, keepdim=True)
    o = o.to(dt).permute(0, 2, 1, 3).reshape(B, N, Da)
    out = linear_fp32(o, w_proj, b_proj)
    if add_residual:
        out = out + x.float()
    return out.to(dt)


def fused_prenorm_mhsa(x, ln_w, ln_b, w_qkv, b_qkv, w_proj, b_proj,
                       num_heads, scale, ln_eps=1e-5, add_residual=True,
                       block_diag=0):
    """x (B, N, D) -> LayerNorm -> MHSA -> proj [-> +x]; see module doc."""
    if x.device.type == "cpu":
        return fused_prenorm_mhsa_reference(
            x, ln_w, ln_b, w_qkv, b_qkv, w_proj, b_proj, num_heads, scale,
            ln_eps, add_residual, block_diag)
    return _launch(x, ln_w, ln_b, w_qkv, b_qkv, w_proj, b_proj, num_heads,
                   scale, ln_eps, add_residual, block_diag)


def _launch(x, ln_w, ln_b, w_qkv, b_qkv, w_proj, b_proj, num_heads, scale,
            ln_eps, add_residual, block_diag):
    global LAUNCHES
    name = "fused_prenorm_mhsa"
    _build.check_operands(name, x=x, ln_w=ln_w, ln_b=ln_b, w_qkv=w_qkv,
                          b_qkv=b_qkv, w_proj=w_proj, b_proj=b_proj)
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (B, N, D), got {tuple(x.shape)}")
    B, N, D = x.shape
    Da3, Do = w_qkv.shape[0], w_proj.shape[0]
    Da = Da3 // 3
    if (w_qkv.shape != (Da3, D) or Da3 % 3 or w_proj.shape != (Do, Da)
            or ln_w.shape != (D,) or ln_b.shape != (D,)
            or b_qkv.shape != (Da3,) or b_proj.shape != (Do,)):
        raise ValueError(f"{name}: weight shapes do not fit x {tuple(x.shape)}")
    if (D % 64 or Da % 64 or Do % 8 or Da % num_heads
            or (Da // num_heads) % 2):
        raise ValueError(f"{name}: D={D} and Da={Da} must be multiples of 64, "
                         f"Do={Do} of 8, and the head dim even "
                         f"(heads={num_heads})")
    if add_residual and Do != D:
        raise ValueError(f"{name}: residual needs Do == D ({Do} != {D})")
    L = _seq_len(N, block_diag)
    lib = _build.load("fused_mhsa", _SIGNATURES)
    smem = lib.vt_mhsa_attention_smem_bytes(L, Da // num_heads)
    if smem > _MAX_SMEM:
        raise ValueError(f"{name}: sequence length {L} needs {smem} bytes of "
                         f"shared memory, above {_MAX_SMEM}")
    rows = B * N
    xn = torch.empty((rows, D), dtype=x.dtype, device=x.device)
    qkv = torch.empty((rows, Da3), dtype=x.dtype, device=x.device)
    attn = torch.empty((rows, Da), dtype=x.dtype, device=x.device)
    out = torch.empty((B, N, Do), dtype=x.dtype, device=x.device)
    P = _build.ptr
    status = lib.vt_fused_prenorm_mhsa(
        P(x), P(ln_w), P(ln_b), P(w_qkv), P(b_qkv), P(w_proj), P(b_proj),
        P(xn), P(qkv), P(attn), P(out), rows, D, Da, Do, num_heads, L,
        float(scale), float(ln_eps), int(bool(add_residual)),
        _build.stream_handle())
    _build.check_status(name, status)
    LAUNCHES += 1
    return out
