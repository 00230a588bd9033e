"""Fused prenorm multi-head self-attention: LayerNorm -> qkv -> attention ->
proj [-> +x], with its backward.

Port of ``videotransformer_tpu/kernels/fused_mhsa_pallas.py``: the forward
body ``_kernel``, the backward body ``_attn_bwd_kernel`` and the
``_vjp_fwd``/``_vjp_bwd`` around them. ``fused_prenorm_mhsa`` is a
``torch.autograd.Function``. On a CUDA tensor its forward launches
``csrc/fused_mhsa.cu`` and its backward ``csrc/fused_mhsa_bwd.cu`` (bf16
only), or they raise; on a CPU tensor they run the plain PyTorch versions
(``fused_prenorm_mhsa_reference``, ``fused_prenorm_mhsa_backward_reference``)
with the kernels' rounding order. There is no other branch.

The forward's qkv and pre-projection attention output are the saved
residuals (the TPU kernel's ``save_qkv``/``save_attn``). The kernel writes
both to device memory in every mode, since its four launches pass them from
one to the next. Autograd keeps them for the backward only when it records
a graph; under ``torch.inference_mode`` or ``no_grad`` both are freed when
the call returns. With ``RECOMPUTE_QKV`` on when the forward runs (the TPU
kernel's ``recompute_qkv`` mode, fused_mhsa_pallas.py:493-518) only attn is
kept: qkv is freed when the call returns, (rows, 3·Da) working-type values
less a layer, and the backward rebuilds it from x, the LayerNorm and
``w_qkv``/``b_qkv`` with B1's own qkv stage, so it has the same bits and
every gradient is the one of the saved mode (the plain backward: the plain
forward's qkv stage). ``out`` has the same bits in every mode. The backward
is one call into the kernel library: B3 (the attention backward, d_xn, the
LayerNorm backward and the sums) with ``_vjp_bwd``'s products around it
(``dw_proj = gᵀ · attn``, ``do = g · W_proj``, ``d_wqkv = dqkvᵀ · xn``; XLA
einsums outside the Pallas kernel, fused_mhsa_pallas.py:531-536, 548-554),
all on the tensor cores. xn there is the LayerNorm rounded to the working
type (the JAX package multiplies its fp32 xn, which the TPU's default matmul
precision feeds to the MXU in bf16 passes); in fp32 the rounding does
nothing. Weight and bias gradients come back in the weight's dtype, as
``_vjp_bwd`` returns them.

The long attention variant (head dim 64, L > 256: joint space-time
attention, L = 1569) runs B5's one-pass kernel (``kernels/flash_attention``)
on each head in place in qkv and attn. It rounds where B5 does, not where
the TPU kernel does: the unnormalised p̃ = exp(s - m_running) (m_running the
row max over the key tiles read so far) is rounded to the working type
before the PV product and the fp32 row sum divides after it, and the
forward also writes the fp32 row log-sum-exp lse (nseq, H, L), a residual
the TPU kernel did not keep. Its backward is B6's two passes: p =
exp(s·scale - lse), delta = rowsum(do · attn) from the saved attn, and the
products bf16(p)ᵀ·do, bf16(ds)·k, bf16(ds)ᵀ·q with ds = p·(dp - delta)·
scale, where the plain backward keeps the TPU kernel's deferred
normalisation. The plain versions are the TPU kernel's order at every L
and stay the yardstick: the same function, other rounding points. The
plain forward returns lse too (exactly, in fp32), so that either forward
feeds either backward.

Layouts: x is (B, N, D) as in the JAX package; weights are in nn.Linear's
(out, in) layout: w_qkv (3·Da, D), w_proj (Do, Da). ``block_diag=T`` (N
divisible by T) makes each length-T block of a sequence its own sequence,
which is what the TPU kernel's block-diagonal mask computes.
"""

import ctypes
from typing import NamedTuple

import torch

from videotransformer_tpu_torch.kernels import _build
from videotransformer_tpu_torch.kernels._plain import (
    layer_norm, layer_norm_backward, linear_fp32)
from videotransformer_tpu_torch.kernels.fused_ffn import split_k

# The memory knob of fused_mhsa_pallas.py:504, read when a forward runs:
# keep no qkv for the backward, which rebuilds it from x (module doc).
RECOMPUTE_QKV = False

# Calls that reached the CUDA kernels (not the plain versions): forward, and
# backward; and each direction's calls by the kernel its attention stage
# took (``attention_variant``, ``attention_bwd_variant``), the backward's
# also under "recompute" when it rebuilt qkv.
LAUNCHES = 0
BWD_LAUNCHES = 0
ATTENTION_LAUNCHES = {"packed": 0, "dense": 0, "long": 0, "general": 0}
ATTENTION_BWD_LAUNCHES = {"packed": 0, "dense": 0, "long": 0, "general": 0,
                          "recompute": 0}
_VARIANT_CODES = {"general": 0, "packed": 1, "dense": 2, "long": 3}

_MAX_SMEM = 232448  # bytes of shared memory one block may use on sm_90
_SIGNATURES = {
    "vt_fused_prenorm_mhsa": [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "vt_mhsa_attention_smem_bytes": [ctypes.c_int] * 3,
}
_BWD_SIGNATURES = {
    "vt_fused_prenorm_mhsa_bwd": [ctypes.c_void_p] * 19 + [ctypes.c_int] * 13
    + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
    "vt_mhsa_attn_bwd": [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
    "vt_mhsa_bwd_smem_bytes": [ctypes.c_int] * 3,
    "vt_mhsa_bwd_scratch_floats": [ctypes.c_int] * 9,
    "vt_mhsa_bwd_qkv": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
    + [ctypes.c_float, ctypes.c_void_p],
}


def _seq_len(N, block_diag):
    if block_diag and N % block_diag:
        raise ValueError(f"N={N} is not a multiple of block_diag={block_diag}")
    return block_diag or N


def attention_variant(L, hd):
    """The kernel of the forward's attention stage for sequences of L
    tokens at head dim hd: "packed" (64 / L sequences a 64-row tensor-core
    tile, block-diagonal mask; the divided temporal L = 8), "dense" (one
    (sequence, head) a block on the tensor cores, L <= 256; the divided
    spatial L = 197), "long" (B5's one-pass kernel on each (sequence,
    head), L > 256; joint space-time L = 1569), else "general" (the
    CUDA-core kernel)."""
    if hd == 64 and 64 % L == 0:
        return "packed"
    if hd == 64 and L <= 256:
        return "dense"
    if hd == 64:
        return "long"
    return "general"


def attention_bwd_variant(L, hd):
    """The kernel of the backward's attention stage for sequences of L
    tokens at head dim hd: "packed" (64 / L sequences a 64-row tensor-core
    tile, keys of other sequences masked; the divided temporal L = 8),
    "dense" (one (sequence, head) a block on the tensor cores, 32 < L <=
    256; the divided spatial L = 197), "long" (B6's two passes on each
    (sequence, head), L > 256; joint space-time L = 1569), else "general"
    (the CUDA-core kernel, one warp a (sequence, head))."""
    if hd == 64 and 64 % L == 0:
        return "packed"
    if hd == 64 and 32 < L <= 256:
        return "dense"
    if hd == 64 and L > 256:
        return "long"
    return "general"


class BackwardPlan(NamedTuple):
    """What the backward kernel runs for one shape: the attention variant,
    and the (slices, k tiles a slice) of dw_proj (Do, Da) and dw_qkv (3Da,
    D), split over the rows as ``fused_ffn.split_k`` splits B4's."""
    variant: str
    split_proj: tuple
    split_qkv: tuple


def backward_plan(rows, D, Da, Do, num_heads, L):
    """The plan of the backward kernel at these widths, from the shape
    alone; raises ValueError on shapes the kernels do not take."""
    if Da % num_heads or rows % L:
        raise ValueError(f"fused_prenorm_mhsa backward: Da={Da} is not a "
                         f"multiple of heads={num_heads}, or {rows} rows of "
                         f"sequences of {L}")
    if D % 8 or Da % 8 or Do % 8 or D > 1024:
        raise ValueError(f"fused_prenorm_mhsa backward: D={D}, Da={Da} and "
                         f"Do={Do} must be multiples of 8, D at most 1024")
    return BackwardPlan(attention_bwd_variant(L, Da // num_heads),
                        split_k(Do, Da, rows), split_k(3 * Da, D, rows))


def _split_heads(t, L, num_heads, parts):
    """(rows, parts·H·hd) -> (parts, rows/L, H, L, hd) in fp32."""
    rows = t.shape[0]
    hd = t.shape[1] // (parts * num_heads)
    return (t.float().reshape(rows // L, L, parts, num_heads, hd)
            .permute(2, 0, 3, 1, 4))


def _merge_heads(t):
    """(nseq, H, L, hd) -> (nseq·L, H·hd)."""
    n, H, L, hd = t.shape
    return t.permute(0, 2, 1, 3).reshape(n * L, H * hd)


def _qkv_reference(x, ln_w, ln_b, w_qkv, b_qkv, ln_eps):
    """The plain qkv stage on x's rows: fp32 LN statistics -> xn in the
    working type; fp32-accumulated ``xn · Wqkvᵀ + b`` -> working type."""
    x2 = x.reshape(-1, x.shape[-1])
    return linear_fp32(layer_norm(x2, ln_w, ln_b, ln_eps), w_qkv,
                       b_qkv).to(x.dtype)


def _forward_reference(x, ln_w, ln_b, w_qkv, b_qkv, w_proj, b_proj,
                       num_heads, scale, ln_eps, add_residual, block_diag):
    """Plain forward on rows, in the kernel's rounding order: fp32 LN
    statistics -> xn; fp32-accumulated qkv -> working type; fp32 scores ×
    scale, max-subtract, exp, p rounded to the working type before the PV
    product, PV in fp32 divided by the fp32 row sum -> working type; fp32
    projection + bias (+ x) -> working type. Returns (out, qkv, attn), each
    (rows, ·), and the fp32 row log-sum-exp of the scaled scores, lse
    (rows / L, H, L)."""
    B, N, D = x.shape
    dt = x.dtype
    L = _seq_len(N, block_diag)
    x2 = x.reshape(B * N, D)
    qkv = _qkv_reference(x, ln_w, ln_b, w_qkv, b_qkv, ln_eps)
    q, k, v = _split_heads(qkv, L, num_heads, 3)
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(dt).float(), v) / l
    attn = _merge_heads(o.to(dt))
    out = linear_fp32(attn, w_proj, b_proj)
    if add_residual:
        out = out + x2.float()
    return out.to(dt), qkv, attn, (m + torch.log(l)).squeeze(-1)


def fused_prenorm_mhsa_reference(x, ln_w, ln_b, w_qkv, b_qkv, w_proj, b_proj,
                                 num_heads, scale, ln_eps=1e-5,
                                 add_residual=True, block_diag=0):
    """The plain forward alone (no autograd of its own rounding order)."""
    out, *_ = _forward_reference(
        x, ln_w, ln_b, w_qkv, b_qkv, w_proj, b_proj, num_heads, scale,
        ln_eps, add_residual, block_diag)
    return out.reshape(*x.shape[:2], w_proj.shape[0])


def _attn_bwd_reference(x, qkv, do, g_res, ln_w, w_qkv, num_heads, scale,
                        ln_eps, block_diag):
    """Plain B3 (fused_mhsa_pallas.py:288-426) on rows: (dqkv, dx, dln_w,
    dln_b, dbqkv), the last three fp32. Rounds to the working type where the
    TPU kernel does: p_un, do·inv_l, ds_un, q·scale·inv_l, dq/dk/dv."""
    dt = x.dtype
    B, N, D = x.shape
    L = _seq_len(N, block_diag)
    q, k, v = _split_heads(qkv, L, num_heads, 3)
    (dout,) = _split_heads(do, L, num_heads, 1)
    rnd = lambda t: t.to(dt).float()
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    p_un = torch.exp(s - s.amax(-1, keepdim=True))
    inv_l = 1.0 / p_un.sum(-1, keepdim=True)
    dv = torch.matmul(rnd(p_un).transpose(-1, -2), rnd(dout * inv_l))
    dp = torch.matmul(dout, v.transpose(-1, -2))
    c = (dp * p_un).sum(-1, keepdim=True) * inv_l
    ds_un = rnd(p_un * (dp - c))
    dq = torch.matmul(ds_un, k) * (scale * inv_l)
    dk = torch.matmul(ds_un.transpose(-1, -2), rnd(q * (scale * inv_l)))
    dqkv = torch.cat([_merge_heads(t.to(dt)) for t in (dq, dk, dv)], dim=-1)
    dbqkv = dqkv.float().sum(0)
    d_xn = dqkv.float() @ w_qkv.float()
    dx, dln_w, dln_b = layer_norm_backward(d_xn, x.reshape(B * N, D), ln_w,
                                           ln_eps)
    if g_res is not None:
        dx = dx + g_res.float()
    return dqkv, dx.to(dt), dln_w, dln_b, dbqkv


def _backward(attn_bwd, g, x, qkv, attn, ln_w, ln_b, w_qkv, w_proj,
              num_heads, scale, ln_eps, add_residual, block_diag):
    """_vjp_bwd (fused_mhsa_pallas.py:523-556) around ``attn_bwd`` (plain or
    kernel B3): (dx, dln_w, dln_b, dw_qkv, db_qkv, dw_proj, db_proj), with
    xn rounded to the working type for dw_qkv, as the kernel reads it."""
    B, N, D = x.shape
    g2 = g.reshape(B * N, -1)
    gf = g2.float()
    db_proj = gf.sum(0).to(w_proj.dtype)
    dw_proj = (gf.t() @ attn.float()).to(w_proj.dtype)
    do = (gf @ w_proj.float()).to(x.dtype)
    dqkv, dx, dln_w, dln_b, dbqkv = attn_bwd(
        x, qkv, do, g2 if add_residual else None, ln_w, w_qkv, num_heads,
        scale, ln_eps, block_diag)
    xn = layer_norm(x.reshape(B * N, D), ln_w, ln_b, ln_eps).float()
    dw_qkv = (dqkv.float().t() @ xn).to(w_qkv.dtype)
    return (dx.reshape(x.shape), dln_w.to(ln_w.dtype), dln_b.to(ln_w.dtype),
            dw_qkv, dbqkv.to(w_qkv.dtype), dw_proj, db_proj)


def fused_prenorm_mhsa_backward_reference(g, x, qkv, attn, ln_w, ln_b, w_qkv,
                                          w_proj, num_heads, scale,
                                          ln_eps=1e-5, add_residual=True,
                                          block_diag=0, b_qkv=None):
    """Plain backward: the gradients of (x, ln_w, ln_b, w_qkv, b_qkv,
    w_proj, b_proj) from the output gradient g and the saved qkv and attn
    (rows, ·), in the TPU kernel's rounding order (it recomputes the row
    statistics, so it takes no lse). ``qkv=None`` is B3's recompute mode:
    qkv rebuilt from x by the plain forward's qkv stage, with ``b_qkv``."""
    if qkv is None:
        qkv = _qkv_reference(x, ln_w, ln_b, w_qkv, b_qkv, ln_eps)
    return _backward(_attn_bwd_reference, g, x, qkv, attn, ln_w, ln_b, w_qkv,
                     w_proj, num_heads, scale, ln_eps, add_residual,
                     block_diag)


class _FusedPrenormMHSA(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w_qkv, b_qkv, w_proj, b_proj, num_heads,
                scale, ln_eps, add_residual, block_diag):
        args = (x, ln_w, ln_b, w_qkv, b_qkv, w_proj, b_proj, num_heads, scale,
                ln_eps, add_residual, block_diag)
        if x.device.type == "cpu":
            out, qkv, attn, lse = _forward_reference(*args)
        else:
            out, qkv, attn, lse = _launch(*args)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(x, None if RECOMPUTE_QKV else qkv, attn,
                                  lse, ln_w, ln_b, w_qkv, w_proj, b_qkv)
            ctx.config = (num_heads, scale, ln_eps, add_residual, block_diag)
        return out.reshape(*x.shape[:2], w_proj.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, qkv, attn, lse, *rest, b_qkv = ctx.saved_tensors
        if g.device.type == "cpu":
            grads = fused_prenorm_mhsa_backward_reference(
                g, x, qkv, attn, *rest, *ctx.config, b_qkv=b_qkv)
        else:
            grads = _launch_backward(g.contiguous(), x, qkv, attn, lse, *rest,
                                     *ctx.config, b_qkv=b_qkv)
        return (*grads, None, None, None, None, None)


def fused_prenorm_mhsa(x, ln_w, ln_b, w_qkv, b_qkv, w_proj, b_proj,
                       num_heads, scale, ln_eps=1e-5, add_residual=True,
                       block_diag=0):
    """x (B, N, D) -> LayerNorm -> MHSA -> proj [-> +x]; see module doc."""
    return _FusedPrenormMHSA.apply(x, ln_w, ln_b, w_qkv, b_qkv, w_proj,
                                   b_proj, num_heads, scale, ln_eps,
                                   add_residual, block_diag)


def _launch(x, ln_w, ln_b, w_qkv, b_qkv, w_proj, b_proj, num_heads, scale,
            ln_eps, add_residual, block_diag, lib=None):
    """(out, qkv, attn, lse) from the forward kernel, lse (rows / L, H, L)
    fp32 for the long variant and None for the others (their backward
    does not read it); ``lib`` is another build of it (``_build.load``), to
    compare designs."""
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
    if lib is None:
        lib = _build.load("fused_mhsa", _SIGNATURES)
    variant = attention_variant(L, Da // num_heads)
    code = _VARIANT_CODES[variant]
    smem = lib.vt_mhsa_attention_smem_bytes(L, Da // num_heads, code)
    if not 0 <= smem <= _MAX_SMEM:
        raise ValueError(f"{name}: sequence length {L} needs {smem} bytes of "
                         f"shared memory, above {_MAX_SMEM}")
    rows = B * N
    stats = torch.empty((rows, 2), dtype=torch.float32, device=x.device)
    qkv = torch.empty((rows, Da3), dtype=x.dtype, device=x.device)
    attn = torch.empty((rows, Da), dtype=x.dtype, device=x.device)
    out = torch.empty((rows, Do), dtype=x.dtype, device=x.device)
    lse = None
    if variant == "long":
        lse = torch.empty((rows // L, num_heads, L), dtype=torch.float32,
                          device=x.device)
    P = _build.ptr
    status = lib.vt_fused_prenorm_mhsa(
        P(x), P(ln_w), P(ln_b), P(w_qkv), P(b_qkv), P(w_proj), P(b_proj),
        P(stats), P(qkv), P(attn), P(lse) if lse is not None else None,
        P(out), rows, D, Da, Do, num_heads, L,
        code, float(scale), float(ln_eps), int(bool(add_residual)),
        _build.stream_handle())
    _build.check_status(name, status)
    LAUNCHES += 1
    ATTENTION_LAUNCHES[variant] += 1
    return out, qkv, attn, lse


def _bwd_prepare(name, x, qkv, w_qkv, Do, num_heads, block_diag, lib):
    """(rows, D, Da, L, plan, lib) of a backward call, after the checks that
    need the library (shared memory); qkv may be None (recompute mode)."""
    B, N, D = x.shape
    rows, Da3 = B * N, w_qkv.shape[0]
    Da = Da3 // 3
    if (w_qkv.shape != (Da3, D) or Da3 % 3
            or (qkv is not None and qkv.shape != (rows, Da3))):
        raise ValueError(f"{name}: qkv or w_qkv {tuple(w_qkv.shape)} do "
                         f"not fit x {tuple(x.shape)}")
    L = _seq_len(N, block_diag)
    plan = backward_plan(rows, D, Da, Do, num_heads, L)
    if lib is None:
        lib = _build.load("fused_mhsa_bwd", _BWD_SIGNATURES)
    hd = Da // num_heads
    smem = lib.vt_mhsa_bwd_smem_bytes(L, hd, _VARIANT_CODES[plan.variant])
    if not 0 <= smem <= _MAX_SMEM:
        raise ValueError(f"{name}: sequence length {L} at head dim {hd} "
                         f"needs {smem} bytes of shared memory, above "
                         f"{_MAX_SMEM}")
    return rows, D, Da, L, plan, lib


def _lse_arg(name, lse, variant, rows, L, num_heads, x):
    """The long variant's pointer to the forward's row log-sum-exp, after
    its checks; None for the others, which do not read it."""
    if variant != "long":
        return None
    if (lse is None or lse.shape != (rows // L, num_heads, L)
            or lse.dtype != torch.float32 or lse.device != x.device
            or not lse.is_contiguous()):
        raise ValueError(f"{name}: the long variant needs the forward's "
                         f"fp32 lse ({rows // L}, {num_heads}, {L}), got "
                         f"{None if lse is None else tuple(lse.shape)}")
    return _build.ptr(lse)


def _count_bwd(variant, recompute=False):
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    ATTENTION_BWD_LAUNCHES[variant] += 1
    ATTENTION_BWD_LAUNCHES["recompute"] += recompute


def _launch_backward(g, x, qkv, attn, lse, ln_w, ln_b, w_qkv, w_proj,
                     num_heads, scale, ln_eps, add_residual, block_diag,
                     b_qkv=None, lib=None):
    """The whole backward (csrc/fused_mhsa_bwd.cu, one call): the gradients
    of (x, ln_w, ln_b, w_qkv, b_qkv, w_proj, b_proj), as
    ``fused_prenorm_mhsa_backward_reference`` returns them (lse is read by
    the long variant only). ``qkv=None`` is the recompute mode: the call
    rebuilds qkv from x with ``b_qkv`` first. ``lib`` is another build of
    the library (``_build.load``), to compare designs."""
    name = "fused_prenorm_mhsa backward"
    recompute = qkv is None
    operands = dict(g=g, x=x, attn=attn, ln_w=ln_w, ln_b=ln_b, w_qkv=w_qkv,
                    w_proj=w_proj)
    if recompute:
        if b_qkv is None:
            raise ValueError(f"{name}: rebuilding qkv needs b_qkv")
        operands["b_qkv"] = b_qkv
    else:
        operands["qkv"] = qkv
    _build.check_operands(name, **operands)
    Do = w_proj.shape[0]
    rows, D, Da, L, plan, lib = _bwd_prepare(name, x, qkv, w_qkv, Do,
                                             num_heads, block_diag, lib)
    if (attn.shape != (rows, Da) or g.numel() != rows * Do
            or w_proj.shape != (Do, Da) or ln_w.shape != (D,)
            or ln_b.shape != (D,)):
        raise ValueError(f"{name}: g {tuple(g.shape)}, attn "
                         f"{tuple(attn.shape)} or the weights do not fit x "
                         f"{tuple(x.shape)}")
    if add_residual and Do != D:
        raise ValueError(f"{name}: residual needs Do == D ({Do} != {D})")
    if recompute and (b_qkv.shape != (3 * Da,) or D % 64):
        raise ValueError(f"{name}: rebuilding qkv needs b_qkv ({3 * Da},) "
                         f"and D={D} a multiple of 64")
    lse_p = _lse_arg(name, lse, plan.variant, rows, L, num_heads, x)
    code = _VARIANT_CODES[plan.variant]
    n_scratch = lib.vt_mhsa_bwd_scratch_floats(rows, D, Da, Do,
                                               plan.split_proj[0],
                                               plan.split_qkv[0], num_heads,
                                               L, code)
    if n_scratch < 0:
        raise ValueError(f"{name}: scratch for {rows} rows is too large")
    dev = x.device
    # xn, do, dqkv; in recompute mode also the rebuilt qkv and the fp32
    # (mean, rstd) of its rows, four bf16 a row
    bf_scratch = torch.empty(rows * (D + 4 * Da + recompute * (3 * Da + 4)),
                             dtype=torch.bfloat16, device=dev)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev)
    dx = torch.empty(x.shape, dtype=torch.bfloat16, device=dev)
    sizes = (D, D, 3 * Da * D, 3 * Da, Do * Da, Do)
    outs = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    dln_w, dln_b, dw_qkv, dbqkv, dw_proj, db_proj = outs.split(sizes)
    P = _build.ptr
    status = lib.vt_fused_prenorm_mhsa_bwd(
        P(g), P(x), None if recompute else P(qkv), P(attn), lse_p, P(ln_w),
        P(ln_b), P(w_qkv), P(b_qkv) if recompute else None, P(w_proj),
        P(bf_scratch), P(scratch), P(dx), P(dln_w), P(dln_b), P(dw_qkv),
        P(dbqkv), P(dw_proj), P(db_proj), rows, D, Da, Do, num_heads, L,
        code, *plan.split_proj, *plan.split_qkv, int(bool(add_residual)),
        int(recompute), float(scale), float(ln_eps), _build.stream_handle())
    _build.check_status(name, status)
    _count_bwd(plan.variant, recompute)
    wt, wdt = ln_w.dtype, w_qkv.dtype
    return (dx, dln_w.to(wt), dln_b.to(wt), dw_qkv.reshape(3 * Da, D).to(wdt),
            dbqkv.to(wdt), dw_proj.reshape(Do, Da).to(w_proj.dtype),
            db_proj.to(w_proj.dtype))


def _attn_bwd_launch(x, qkv, do, g_res, ln_w, w_qkv, num_heads, scale,
                     ln_eps, block_diag, attn=None, lse=None, lib=None):
    """B3 alone from do (csrc/fused_mhsa_bwd.cu's ``vt_mhsa_attn_bwd``: the
    attention backward, d_xn, the LayerNorm backward and the sums); the
    same contract as ``_attn_bwd_reference``, whose row statistics the long
    variant reads from the forward's attn and lse instead. The backward of
    the autograd Function calls ``_launch_backward``; this entry times and
    tests B3's own part."""
    name = "fused_prenorm_mhsa backward"
    tensors = dict(x=x, qkv=qkv, do=do, ln_w=ln_w, w_qkv=w_qkv)
    if g_res is not None:
        tensors["g"] = g_res
    _build.check_operands(name, **tensors)
    D = x.shape[-1]
    rows, D, Da, L, plan, lib = _bwd_prepare(name, x, qkv, w_qkv, D,
                                             num_heads, block_diag, lib)
    if do.shape != (rows, Da):
        raise ValueError(f"{name}: do {tuple(do.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    lse_p = _lse_arg(name, lse, plan.variant, rows, L, num_heads, x)
    if lse_p is not None:
        _build.check_operands(name, attn=attn)
        if attn.shape != (rows, Da):
            raise ValueError(f"{name}: attn {tuple(attn.shape)} does not fit "
                             f"x {tuple(x.shape)}")
    dev = x.device
    code = _VARIANT_CODES[plan.variant]
    dqkv = torch.empty((rows, 3 * Da), dtype=torch.bfloat16, device=dev)
    dx = torch.empty((rows, D), dtype=torch.bfloat16, device=dev)
    f32 = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    scratch = f32(lib.vt_mhsa_bwd_scratch_floats(rows, D, Da, D, 1, 1,
                                                 num_heads, L, code))
    dln_w, dln_b, dbqkv = f32(D), f32(D), f32(3 * Da)
    P = _build.ptr
    status = lib.vt_mhsa_attn_bwd(
        P(x), P(qkv), P(do), P(attn) if lse_p is not None else None, lse_p,
        P(g_res) if g_res is not None else None, P(ln_w), P(w_qkv), P(dqkv),
        P(scratch), P(dx), P(dln_w), P(dln_b), P(dbqkv), rows, D, Da,
        num_heads, L, code, float(scale), float(ln_eps),
        _build.stream_handle())
    _build.check_status(name, status)
    _count_bwd(plan.variant)
    return dqkv, dx, dln_w, dln_b, dbqkv


def _recompute_qkv_launch(x, ln_w, ln_b, w_qkv, b_qkv, ln_eps, lib=None):
    """B3's recompute stage alone (csrc/fused_mhsa_bwd.cu's
    ``vt_mhsa_bwd_qkv``): the (rows, 3·Da) qkv its whole call rebuilds from
    x in recompute mode, to hold against the forward's saved qkv, bit for
    bit; a B3 launch in recompute mode by the counts. The plain version is
    ``_qkv_reference``."""
    name = "fused_prenorm_mhsa backward (qkv stage)"
    _build.check_operands(name, x=x, ln_w=ln_w, ln_b=ln_b, w_qkv=w_qkv,
                          b_qkv=b_qkv)
    D = x.shape[-1]
    rows, Da3 = x.numel() // D, w_qkv.shape[0]
    if (w_qkv.shape != (Da3, D) or b_qkv.shape != (Da3,)
            or ln_w.shape != (D,) or ln_b.shape != (D,) or D % 64
            or Da3 % 24):  # Da = Da3 / 3 a multiple of 8
        raise ValueError(f"{name}: the weights do not fit x "
                         f"{tuple(x.shape)}, or D={D} is not a multiple "
                         f"of 64")
    if lib is None:
        lib = _build.load("fused_mhsa_bwd", _BWD_SIGNATURES)
    stats = torch.empty((rows, 2), dtype=torch.float32, device=x.device)
    qkv = torch.empty((rows, Da3), dtype=x.dtype, device=x.device)
    P = _build.ptr
    status = lib.vt_mhsa_bwd_qkv(
        P(x), P(ln_w), P(ln_b), P(w_qkv), P(b_qkv), P(stats), P(qkv), rows,
        D, Da3 // 3, float(ln_eps), _build.stream_handle())
    _build.check_status(name, status)
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    ATTENTION_BWD_LAUNCHES["recompute"] += 1
    return qkv
