"""MViT's pooling convolutions: the q, k and v pools of one attention block
at once, on the token layout, with their backward.

A pool is pytorchvideo's depthwise ``Conv3d(C, C, k, s, k // 2, groups=C,
bias=False)`` whose ``(head_dim, 1, kT, kH, kW)`` weight is tiled over the
heads (``models/mvit.py``). It replaces no TPU kernel: the JAX package left
these convolutions to XLA, outside Pallas. ``pool_qkv`` takes the block's
fused ``qkv`` activation (B, L, 3C), L = T·H·W, and returns q, k and v: a
slice with a pool as (B, T'·H'·W', C) token rows, one without as the
(B, L, C) view of its columns. It is one ``torch.autograd.Function`` whose
backward returns the whole ``d_qkv`` at once, where three slice backwards
each zero-filled and added a tensor of its size.

On a CUDA tensor the function launches ``csrc/mvit_pool.cu`` (bf16, one
launch forward, three backward for the block's three pools) or raises; on a
CPU tensor it runs the plain version, the ``F.conv3d`` of each slice with
the weight cast to the working type and ``.repeat``-ed over the heads, and
its backward by autograd. There is no other branch. The kernels sum in
fp32 in a fixed order (the source's note), so a step repeats to the bit;
they read the weight in fp32 and return its gradient summed in fp32, in the
weight's dtype, where the plain version's is rounded to the working type
before the cast back.
"""

import ctypes
import math

import torch
import torch.nn.functional as F

from videotransformer_tpu_torch.kernels import _build

# Calls that reached the CUDA kernels (not the plain versions), a block's
# three pools each: forward (one launch), and backward (three launches).
LAUNCHES = 0
BWD_LAUNCHES = 0

COPY, POOL = 1, 2  # a slice's mode in the C geometry (csrc/mvit_pool.cu)
MAX_SMEM = 232448  # an H100 block's shared memory, bytes
MAX_INDEX = 2**31 - 1  # the kernels index tokens and vectors in 32 bits

_SIGNATURES = {
    "vt_mvit_pool_fwd": [ctypes.c_void_p] * 9,
    "vt_mvit_pool_scratch_floats": [ctypes.c_void_p],
    "vt_mvit_pool_bwd": [ctypes.c_void_p] * 14,
}


def out_grid(thw, kernel, stride):
    """(T', H', W') of a pool over ``thw`` with padding k // 2."""
    return tuple((n + 2 * (k // 2) - k) // s + 1
                 for n, k, s in zip(thw, kernel, stride))


def check_geometry(B, thw, C, pools):
    """The head dim of ``pools`` ((weight, kernel, stride) or None for q, k
    and v) over (B, T·H·W, 3C) tokens; ValueError for a geometry the kernels
    do not take (``plan`` in csrc/mvit_pool.cu refuses the same)."""
    name = "mvit_pool"
    dims = {p[0].shape[0] for p in pools if p is not None}
    if len(dims) != 1:
        raise ValueError(f"{name}: the pools' head dims {sorted(dims)} are "
                         f"not one")
    hd = dims.pop()
    if C % 8 or hd % 8 or C % hd or C > 3072 or hd > 1024:
        raise ValueError(f"{name}: C = {C} with head dim {hd}: both must be "
                         f"multiples of 8, C of the head dim, C <= 3072")
    for p in pools:
        if p is None:
            continue
        w, kernel, stride = p
        taps = math.prod(kernel)
        if len(kernel) != 3 or len(stride) != 3 or min(kernel) < 1 \
                or min(stride) < 1 or tuple(w.shape) != (hd, 1, *kernel):
            raise ValueError(f"{name}: kernel {kernel}, stride {stride}, "
                             f"weight {tuple(w.shape)}")
        if taps * hd * 4 > MAX_SMEM:
            raise ValueError(f"{name}: the weight table of kernel {kernel} "
                             f"({taps * hd * 4} bytes) does not fit a "
                             f"block's shared memory")
    # an output grid is at most the input's plus one a side (even kernels)
    if B * math.prod(n + 1 for n in thw) * 3 * C // 8 > MAX_INDEX:
        raise ValueError(f"{name}: {B} x {tuple(thw)} x {3 * C} is too large")
    return hd


def pool_reference(t, thw, weight, kernel, stride):
    """The plain pool of (B, L, C) token rows over the grid ``thw``: the
    depthwise conv3d with the weight cast to t's dtype and tiled over the
    heads -> (B, T'·H'·W', C)."""
    B, _, C = t.shape
    w = weight.to(t.dtype).repeat(C // weight.shape[0], 1, 1, 1, 1)
    u = F.conv3d(t.reshape(B, *thw, C).permute(0, 4, 1, 2, 3), w,
                 stride=stride, padding=[k // 2 for k in kernel], groups=C)
    return u.permute(0, 2, 3, 4, 1).reshape(B, -1, C)


def _forward_reference(qkv, thw, geometry, weights):
    C = qkv.shape[-1] // 3
    return tuple(
        qkv[..., i * C:(i + 1) * C] if g is None
        else pool_reference(qkv[..., i * C:(i + 1) * C], thw, w, *g)
        for i, (g, w) in enumerate(zip(geometry, weights)))


def _backward_reference(qkv, thw, geometry, weights, grads):
    """(d_qkv, dw_q, dw_k, dw_v) of the plain forward by autograd."""
    with torch.enable_grad():
        x = qkv.detach().requires_grad_()
        ws = [None if w is None else w.detach().requires_grad_()
              for w in weights]
        outs = _forward_reference(x, thw, geometry, ws)
        got = list(torch.autograd.grad(
            outs, [x] + [w for w in ws if w is not None], grads))
    d_qkv = got.pop(0)
    return (d_qkv, *[None if w is None else got.pop(0) for w in ws])


def _geom(qkv, thw, geometry, hd):
    B, _, C3 = qkv.shape
    g = [B, *thw, C3 // 3, hd]
    for p in geometry:
        g += [COPY, 1, 1, 1, 1, 1, 1] if p is None else [POOL, *p[0], *p[1]]
    return (ctypes.c_int * len(g))(*g)


def _check_weights(name, weights, device):
    for w in weights:
        if w is not None and (w.device != device or w.dtype != torch.float32
                              or not w.is_contiguous()):
            raise ValueError(f"{name}: a weight is {w.dtype} on {w.device} "
                             f"(contiguous {w.is_contiguous()}), expected "
                             f"contiguous float32 on {device}")


def _launch(qkv, thw, geometry, weights, lib=None):
    """q, k, v from the forward kernel; ``lib`` is another build of it
    (``_build.load``), to compare designs."""
    global LAUNCHES
    name = "mvit_pool"
    _build.check_operands(name, qkv=qkv)
    _check_weights(name, weights, qkv.device)
    B, L, C3 = qkv.shape
    C = C3 // 3
    hd = check_geometry(B, thw, C, [None if g is None else (w, *g)
                                    for g, w in zip(geometry, weights)])
    if lib is None:
        lib = _build.load("mvit_pool", _SIGNATURES)
    outs = [qkv[..., i * C:(i + 1) * C] if g is None else qkv.new_empty(
                (B, math.prod(out_grid(thw, *g)), C))
            for i, g in enumerate(geometry)]
    P = lambda t, g: None if g is None else _build.ptr(t)
    status = lib.vt_mvit_pool_fwd(
        _build.ptr(qkv), _geom(qkv, thw, geometry, hd),
        *[P(w, g) for w, g in zip(weights, geometry)],
        *[P(o, g) for o, g in zip(outs, geometry)], _build.stream_handle())
    _build.check_status(name, status)
    LAUNCHES += 1
    return tuple(outs)


def _launch_backward(qkv, thw, geometry, weights, grads, lib=None):
    """(d_qkv, dw_q, dw_k, dw_v) from the backward kernels; ``lib`` as in
    ``_launch``."""
    global BWD_LAUNCHES
    name = "mvit_pool backward"
    _build.check_operands(name, qkv=qkv, **{f"d{n}": g for n, g in zip(
        "qkv", grads)})
    _check_weights(name, weights, qkv.device)
    B, L, C3 = qkv.shape
    C = C3 // 3
    hd = check_geometry(B, thw, C, [None if g is None else (w, *g)
                                    for g, w in zip(geometry, weights)])
    for g, d in zip(geometry, grads):
        want = (B, L if g is None else math.prod(out_grid(thw, *g)), C)
        if tuple(d.shape) != want:
            raise ValueError(f"{name}: a gradient is {tuple(d.shape)}, "
                             f"expected {want}")
    if lib is None:
        lib = _build.load("mvit_pool", _SIGNATURES)
    geom = _geom(qkv, thw, geometry, hd)
    n = lib.vt_mvit_pool_scratch_floats(geom)
    if n < 0:
        raise ValueError(f"{name}: the kernels refuse the geometry "
                         f"{list(geom)}")
    d_qkv = torch.empty_like(qkv)
    partial = torch.empty(max(n, 1), dtype=torch.float32, device=qkv.device)
    dws = [None if g is None else torch.empty_like(w)
           for g, w in zip(geometry, weights)]
    P = lambda t: None if t is None else _build.ptr(t)
    status = lib.vt_mvit_pool_bwd(
        P(qkv), P(d_qkv), geom, *[P(w) for w in weights],
        *[P(d) for d in grads], P(partial), *[P(d) for d in dws],
        _build.stream_handle())
    _build.check_status(name, status)
    BWD_LAUNCHES += 1
    return (d_qkv, *dws)


class _PoolQKV(torch.autograd.Function):

    @staticmethod
    def forward(ctx, qkv, thw, geometry, w_q, w_k, w_v):
        weights = (w_q, w_k, w_v)
        if qkv.device.type == "cpu":
            outs = _forward_reference(qkv, thw, geometry, weights)
        else:
            outs = _launch(qkv, thw, geometry, _fp32(weights))
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(qkv, *weights)
            ctx.geometry = (thw, geometry)
        return outs

    @staticmethod
    def backward(ctx, dq, dk, dv):
        qkv, *weights = ctx.saved_tensors
        thw, geometry = ctx.geometry
        if qkv.device.type == "cpu":
            grads = _backward_reference(qkv, thw, geometry, weights,
                                        (dq, dk, dv))
        else:
            d_qkv, *dws = _launch_backward(
                qkv, thw, geometry, _fp32(weights),
                [g.contiguous() for g in (dq, dk, dv)])
            grads = (d_qkv, *[None if d is None else d.to(w.dtype)
                              for d, w in zip(dws, weights)])
        return grads[0], None, None, *grads[1:]


def _fp32(weights):
    """The weights as the kernels read them: contiguous fp32 (a model cast
    to bf16 holds bf16 weights; fp32 holds them exactly)."""
    return [None if w is None else w.float().contiguous() for w in weights]


def pool_qkv(qkv, thw, pools):
    """q, k and v of ``qkv`` (B, T·H·W, 3C) over the grid ``thw``, each
    pooled by its entry of ``pools``, (weight (head_dim, 1, kT, kH, kW),
    kernel, stride) or None (the slice as it is). Raises ValueError on a
    geometry the kernels do not take, on either device."""
    B, L, C3 = qkv.shape
    if C3 % 3 or L != math.prod(thw):
        raise ValueError(f"mvit_pool: qkv {tuple(qkv.shape)} is not (B, "
                         f"{math.prod(thw)}, 3C) for the grid {tuple(thw)}")
    C = C3 // 3
    if all(p is None for p in pools):
        return tuple(qkv[..., i * C:(i + 1) * C] for i in range(3))
    check_geometry(B, thw, C, pools)
    geometry = tuple(None if p is None else (tuple(p[1]), tuple(p[2]))
                     for p in pools)
    return _PoolQKV.apply(qkv, tuple(thw), geometry,
                          *[None if p is None else p[0] for p in pools])
