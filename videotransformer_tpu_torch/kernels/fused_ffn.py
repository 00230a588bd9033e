"""Fused prenorm FFN: LayerNorm -> fc1 -> erf-GELU -> fc2, forward only.

Port of ``videotransformer_tpu/kernels/fused_ffn_pallas.py::_kernel``. On a
CUDA tensor ``fused_prenorm_ffn`` launches the hand-written kernel in
``csrc/fused_ffn.cu`` (bf16 only) or raises; on a CPU tensor it runs
``fused_prenorm_ffn_reference``, the plain PyTorch version with the same
rounding order. There is no other branch. No residual: the caller adds it.

x is (..., D) and is flattened to rows; weights are in nn.Linear's (out, in)
layout: w1 (hidden, D), w2 (Do, hidden).
"""

import ctypes
import math

import torch

from videotransformer_tpu_torch.kernels import _build
from videotransformer_tpu_torch.kernels._plain import layer_norm, linear_fp32

# Calls that reached the CUDA kernel (not the plain version).
LAUNCHES = 0

_SIGNATURES = {
    "vt_fused_prenorm_ffn": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
    + [ctypes.c_float, ctypes.c_void_p],
}


def fused_prenorm_ffn_reference(x, ln_w, ln_b, w1, b1, w2, b2, ln_eps=1e-5):
    """Plain version, in the kernel's rounding order: fp32 LN statistics ->
    xn; fc1 accumulated in fp32 + b1, exact erf-GELU in fp32 -> working type;
    fc2 accumulated in fp32 + b2 -> working type."""
    shape = x.shape
    dt = x.dtype
    xn = layer_norm(x.reshape(-1, shape[-1]), ln_w, ln_b, ln_eps)
    h = linear_fp32(xn, w1, b1)
    h = (0.5 * h * (1.0 + torch.erf(h * (1.0 / math.sqrt(2.0))))).to(dt)
    out = linear_fp32(h, w2, b2).to(dt)
    return out.reshape(*shape[:-1], w2.shape[0])


def fused_prenorm_ffn(x, ln_w, ln_b, w1, b1, w2, b2, ln_eps=1e-5):
    """x (..., D) -> LN -> fc1 -> erf-GELU -> fc2; see module doc."""
    if x.device.type == "cpu":
        return fused_prenorm_ffn_reference(x, ln_w, ln_b, w1, b1, w2, b2,
                                           ln_eps)
    return _launch(x, ln_w, ln_b, w1, b1, w2, b2, ln_eps)


def _launch(x, ln_w, ln_b, w1, b1, w2, b2, ln_eps):
    global LAUNCHES
    name = "fused_prenorm_ffn"
    _build.check_operands(name, x=x, ln_w=ln_w, ln_b=ln_b, w1=w1, b1=b1,
                          w2=w2, b2=b2)
    shape = x.shape
    D = shape[-1]
    hidden, Do = w1.shape[0], w2.shape[0]
    if (w1.shape != (hidden, D) or w2.shape != (Do, hidden)
            or ln_w.shape != (D,) or ln_b.shape != (D,)
            or b1.shape != (hidden,) or b2.shape != (Do,)):
        raise ValueError(f"{name}: weight shapes do not fit x {tuple(shape)}")
    if D % 64 or hidden % 64 or Do % 8:
        raise ValueError(f"{name}: D={D} and hidden={hidden} must be "
                         f"multiples of 64, Do={Do} of 8")
    rows = x.numel() // D
    lib = _build.load("fused_ffn", _SIGNATURES)
    xn = torch.empty((rows, D), dtype=x.dtype, device=x.device)
    h = torch.empty((rows, hidden), dtype=x.dtype, device=x.device)
    out = torch.empty((*shape[:-1], Do), dtype=x.dtype, device=x.device)
    P = _build.ptr
    status = lib.vt_fused_prenorm_ffn(
        P(x), P(ln_w), P(ln_b), P(w1), P(b1), P(w2), P(b2), P(xn), P(h),
        P(out), rows, D, hidden, Do, float(ln_eps), _build.stream_handle())
    _build.check_status(name, status)
    LAUNCHES += 1
    return out
