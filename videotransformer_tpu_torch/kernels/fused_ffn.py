"""Fused prenorm FFN: LayerNorm -> fc1 -> erf-GELU -> fc2, with its backward.

Port of ``videotransformer_tpu/kernels/fused_ffn_pallas.py``: the forward
body ``_kernel`` and the backward body ``_bwd_kernel`` with the
``_vjp_fwd``/``_vjp_bwd`` around them. ``fused_prenorm_ffn`` is a
``torch.autograd.Function``. On a CUDA tensor its forward launches
``csrc/fused_ffn.cu`` and its backward ``csrc/fused_ffn_bwd.cu`` (bf16 only),
or they raise; on a CPU tensor they run the plain PyTorch versions
(``fused_prenorm_ffn_reference`` and ``fused_prenorm_ffn_backward_reference``)
with the kernels' rounding order. There is no other branch. No residual:
the caller adds it.

When a gradient is wanted the forward also saves the pre-GELU hidden h_pre
(the TPU kernel's ``with_hpre``), so the backward recomputes only the
LayerNorm and the GELU. Weight and bias gradients come back in the weight's
dtype, as ``_vjp_bwd`` returns them.

x is (..., D) and is flattened to rows; weights are in nn.Linear's (out, in)
layout: w1 (hidden, D), w2 (Do, hidden).
"""

import ctypes
import math

import torch

from videotransformer_tpu_torch.kernels import _build
from videotransformer_tpu_torch.kernels._plain import (
    layer_norm, layer_norm_backward, layer_norm_fp32, linear_fp32)

# Calls that reached the CUDA kernels (not the plain versions): forward, and
# backward.
LAUNCHES = 0
BWD_LAUNCHES = 0

_SIGNATURES = {
    "vt_fused_prenorm_ffn": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
    + [ctypes.c_float, ctypes.c_void_p],
    "vt_ffn_fc1_stage": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
}
_BWD_SIGNATURES = {
    "vt_fused_prenorm_ffn_bwd": [ctypes.c_void_p] * 19 + [ctypes.c_int] * 8
    + [ctypes.c_float, ctypes.c_void_p],
    "vt_ffn_bwd_scratch_floats": [ctypes.c_int] * 6,
}

# The backward's weight gradients (csrc/fused_ffn_bwd.cu, and B3's in
# csrc/fused_mhsa_bwd.cu) are products whose
# K is the row count, on 128 x 128 output tiles (sm90_gemm.cuh) with 64-row
# k tiles. Split over the rows they run as SPLIT_K_BLOCKS or more blocks
# (two for each of an H100's 132 SMs) where the rows allow slices of at
# least MIN_SLICE_KTILES k tiles, and never more than MAX_SLICES slices (one
# chunk of the ordered sum).
WGRAD_TILE, K_TILE = 128, 64
SPLIT_K_BLOCKS, MIN_SLICE_KTILES, MAX_SLICES = 264, 8, 32

_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def split_k(M, N, K):
    """(slices, k tiles a slice) of an (M, N) weight gradient summed over K
    rows: from the shape alone, so that every run sums the same slices in
    the same order. Slice z takes k tiles [z·per, (z + 1)·per); every row
    lies in exactly one slice and no slice is empty."""
    tiles = -(-M // WGRAD_TILE) * -(-N // WGRAD_TILE)
    ktiles = -(-K // K_TILE)
    slices = max(1, min(-(-SPLIT_K_BLOCKS // tiles),
                        ktiles // MIN_SLICE_KTILES, MAX_SLICES))
    per = -(-ktiles // slices)
    return -(-ktiles // per), per


def _gelu(h):
    return 0.5 * h * (1.0 + torch.erf(h * _INV_SQRT2))


def _gelu_grad(h):
    """d/dh of the exact erf-GELU (fused_ffn_pallas.py::_gelu_grad)."""
    cdf = 0.5 * (1.0 + torch.erf(h * _INV_SQRT2))
    return cdf + h * torch.exp(-0.5 * h * h) * _INV_SQRT_2PI


def _forward_reference(x, ln_w, ln_b, w1, b1, w2, b2, ln_eps):
    """Plain forward, in the kernel's rounding order: fp32 LN statistics ->
    xn; fc1 accumulated in fp32 + b1 -> h_pre (rounded to the working type,
    as saved); exact erf-GELU of the fp32 value -> working type; fc2
    accumulated in fp32 + b2 -> working type. Returns (out, h_pre) on rows."""
    dt = x.dtype
    xn = layer_norm(x.reshape(-1, x.shape[-1]), ln_w, ln_b, ln_eps)
    h = linear_fp32(xn, w1, b1)
    out = linear_fp32(_gelu(h).to(dt), w2, b2).to(dt)
    return out, h.to(dt)


def fused_prenorm_ffn_reference(x, ln_w, ln_b, w1, b1, w2, b2, ln_eps=1e-5):
    """The plain forward alone (no autograd of its own rounding order)."""
    out, _ = _forward_reference(x, ln_w, ln_b, w1, b1, w2, b2, ln_eps)
    return out.reshape(*x.shape[:-1], w2.shape[0])


def fused_prenorm_ffn_backward_reference(g, x, h_pre, ln_w, ln_b, w1, w2,
                                         ln_eps=1e-5):
    """Plain backward, in B4's rounding order (fused_ffn_pallas.py:168-238,
    :298-307): bf16 g into both fc2 products, dh_pre = dh · gelu'(h_pre) in
    fp32 and rounded for both fc1 products, db1 from the fp32 dh_pre, the
    LayerNorm backward in fp32. Returns (dx, dln_w, dln_b, dw1, db1, dw2,
    db2), weight grads in the weight's dtype."""
    dt = x.dtype
    D = x.shape[-1]
    x2 = x.reshape(-1, D)
    g2 = g.reshape(-1, g.shape[-1]).to(dt).float()
    hp = h_pre.float()
    xn = layer_norm(x2, ln_w, ln_b, ln_eps).float()
    h = _gelu(hp).to(dt).float()
    dh = g2 @ w2.float()
    dw2 = g2.t() @ h
    db2 = g2.sum(0)
    dh_pre = dh * _gelu_grad(hp)
    db1 = dh_pre.sum(0)
    dh_pre_c = dh_pre.to(dt).float()
    dw1 = dh_pre_c.t() @ xn
    dxn = dh_pre_c @ w1.float()
    dx, dln_w, dln_b = layer_norm_backward(dxn, x2, ln_w, ln_eps)
    return (dx.to(dt).reshape(x.shape), dln_w.to(ln_w.dtype),
            dln_b.to(ln_b.dtype), dw1.to(w1.dtype), db1.to(w1.dtype),
            dw2.to(w2.dtype), db2.to(w2.dtype))


class _FusedPrenormFFN(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2, ln_eps, save):
        if x.device.type == "cpu":
            out, h_pre = _forward_reference(x, ln_w, ln_b, w1, b1, w2, b2,
                                            ln_eps)
        else:
            out, h_pre = _launch(x, ln_w, ln_b, w1, b1, w2, b2, ln_eps, save)
        if save:
            ctx.save_for_backward(x, h_pre, ln_w, ln_b, w1, w2)
            ctx.ln_eps = ln_eps
        return out.reshape(*x.shape[:-1], w2.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, h_pre, ln_w, ln_b, w1, w2 = ctx.saved_tensors
        if g.device.type == "cpu":
            grads = fused_prenorm_ffn_backward_reference(
                g, x, h_pre, ln_w, ln_b, w1, w2, ctx.ln_eps)
        else:
            grads = _launch_backward(g.contiguous(), x, h_pre, ln_w, ln_b,
                                     w1, w2, ctx.ln_eps)
        return (*grads, None, None)


def _wants_grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def fused_prenorm_ffn(x, ln_w, ln_b, w1, b1, w2, b2, ln_eps=1e-5):
    """x (..., D) -> LN -> fc1 -> erf-GELU -> fc2; see module doc. The
    residual h_pre is kept only when a gradient is wanted."""
    save = _wants_grad(x, ln_w, ln_b, w1, b1, w2, b2)
    return _FusedPrenormFFN.apply(x, ln_w, ln_b, w1, b1, w2, b2, ln_eps,
                                  save)


def _check_shapes(name, x, ln_w, ln_b, w1, b1, w2, b2):
    D = x.shape[-1]
    hidden, Do = w1.shape[0], w2.shape[0]
    if (w1.shape != (hidden, D) or w2.shape != (Do, hidden)
            or ln_w.shape != (D,) or ln_b.shape != (D,)
            or (b1 is not None and b1.shape != (hidden,))
            or (b2 is not None and b2.shape != (Do,))):
        raise ValueError(f"{name}: weight shapes do not fit x {tuple(x.shape)}")
    return D, hidden, Do


def _launch(x, ln_w, ln_b, w1, b1, w2, b2, ln_eps, save_h_pre, lib=None):
    """(out, h_pre or None) from the forward kernel; ``lib`` is another
    build of it (``_build.load``), to compare designs."""
    global LAUNCHES
    name = "fused_prenorm_ffn"
    _build.check_operands(name, x=x, ln_w=ln_w, ln_b=ln_b, w1=w1, b1=b1,
                          w2=w2, b2=b2)
    D, hidden, Do = _check_shapes(name, x, ln_w, ln_b, w1, b1, w2, b2)
    if D % 64 or hidden % 64 or Do % 8:
        raise ValueError(f"{name}: D={D} and hidden={hidden} must be "
                         f"multiples of 64, Do={Do} of 8")
    rows = x.numel() // D
    if lib is None:
        lib = _build.load("fused_ffn", _SIGNATURES)
    empty = lambda *s: torch.empty(s, dtype=x.dtype, device=x.device)
    xn, h, out = empty(rows, D), empty(rows, hidden), empty(rows, Do)
    h_pre = empty(rows, hidden) if save_h_pre else None
    P = _build.ptr
    status = lib.vt_fused_prenorm_ffn(
        P(x), P(ln_w), P(ln_b), P(w1), P(b1), P(w2), P(b2), P(xn), P(h),
        P(h_pre) if save_h_pre else None, P(out), rows, D, hidden, Do,
        float(ln_eps), _build.stream_handle())
    _build.check_status(name, status)
    LAUNCHES += 1
    return out, h_pre


def _launch_backward(g, x, h_pre, ln_w, ln_b, w1, w2, ln_eps, lib=None):
    """The backward kernel's gradients; ``lib`` is another build of it
    (``_build.load``), to compare designs."""
    global BWD_LAUNCHES
    name = "fused_prenorm_ffn backward"
    _build.check_operands(name, g=g, x=x, h_pre=h_pre, ln_w=ln_w, ln_b=ln_b,
                          w1=w1, w2=w2)
    D, hidden, Do = _check_shapes(name, x, ln_w, ln_b, w1, None, w2, None)
    rows = x.numel() // D
    if g.numel() != rows * Do or h_pre.shape != (rows, hidden):
        raise ValueError(f"{name}: g {tuple(g.shape)} or h_pre "
                         f"{tuple(h_pre.shape)} do not fit x {tuple(x.shape)}")
    if D % 64 or hidden % 64 or Do % 8 or D > 1024:
        raise ValueError(f"{name}: D={D} and hidden={hidden} must be "
                         f"multiples of 64, Do={Do} of 8, D at most 1024")
    if lib is None:
        lib = _build.load("fused_ffn_bwd", _BWD_SIGNATURES)
    split2, split1 = split_k(Do, hidden, rows), split_k(hidden, D, rows)
    n_scratch = lib.vt_ffn_bwd_scratch_floats(rows, D, hidden, Do,
                                              split2[0], split1[0])
    if n_scratch < 0:
        raise ValueError(f"{name}: scratch for {rows} rows is too large")
    dev = x.device
    bf = lambda *s: torch.empty(s, dtype=torch.bfloat16, device=dev)
    f32 = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    xn, h, dh_pre, dxn = bf(rows, D), bf(rows, hidden), bf(rows, hidden), \
        f32(rows, D)
    scratch = f32(n_scratch)
    dx = bf(*x.shape)
    dln_w, dln_b, dw1, db1, dw2, db2 = (f32(D), f32(D), f32(hidden, D),
                                        f32(hidden), f32(Do, hidden), f32(Do))
    P = _build.ptr
    status = lib.vt_fused_prenorm_ffn_bwd(
        P(x), P(h_pre), P(g), P(ln_w), P(ln_b), P(w1), P(w2), P(xn), P(h),
        P(dh_pre), P(dxn), P(scratch), P(dx), P(dln_w), P(dln_b), P(dw1),
        P(db1), P(dw2), P(db2), rows, D, hidden, Do, *split2, *split1,
        float(ln_eps), _build.stream_handle())
    _build.check_status(name, status)
    BWD_LAUNCHES += 1
    return (dx, dln_w.to(ln_w.dtype), dln_b.to(ln_b.dtype), dw1.to(w1.dtype),
            db1.to(w1.dtype), dw2.to(w2.dtype), db2.to(w2.dtype))
