"""Flash attention ``softmax(q kᵀ · scale) v``, with its backward.

Port of ``videotransformer_tpu/kernels/flash_attention_pallas.py``: the
forward body ``_fwd_kernel`` and the backward body ``_bwd_kernel`` with the
``custom_vjp`` around them. ``flash_attention`` is a
``torch.autograd.Function`` on ``(B, H, N*, hd)`` tensors, with Nq != Nkv
allowed (MViT's pooled keys and values). On a CUDA tensor its forward
launches ``csrc/flash_attention.cu`` and its backward
``csrc/flash_attention_bwd.cu`` (bf16, head dim 32, 64, 96 or 128), or they
raise; on a CPU tensor they run the plain PyTorch versions
(``flash_attention_reference``, ``flash_attention_backward_reference``).
There is no other branch.

Rounding order. The plain forward is the TPU kernel's, exactly: fp32
scores × scale, p = exp(s - max) / sum in fp32, p rounded to the working
type before the PV product, fp32 accumulation, the output rounded. The CUDA
forward makes one pass over the keys with an online softmax, so it rounds
the unnormalised p̃ = exp(s - m_running) (m_running the row max over the key
tiles read so far) before the PV product and divides by the row sum in fp32
after it: the same function and products, another rounding point. On an
H100 the forward stays within 1.9e-3 to 3.0e-3 of max|plain| at the six
MViT shapes (chip_smoke.py; a two-pass design that rounded the normalised
p read 3.2e-3 to 4.8e-3), inside the 1e-2 that chip_smoke.py and
tests/test_torch_cuda.py hold it to. The forward also returns the row
log-sum-exp (fp32), a residual the TPU kernel did not keep: the backward
recomputes p = exp(s - lse) from it. The backward takes
delta = rowsum(do · o) (fp32, from the saved o) where the TPU kernel took
rowsum(dp · p) over its whole key row; the two are equal up to rounding.
p and ds are rounded to the working type before the products they feed
(dv = pᵀ do, dq = ds k, dk = dsᵀ q), whose sums are fp32; the kernel
rounds at those points too. dq comes back in q's dtype, dk and dv in k's
(the TPU kernel's contract, flash_attention_pallas.py:185-200). The
kernels take scale > 0.
"""

import ctypes

import torch

from videotransformer_tpu_torch.kernels import _build

# Calls that reached the CUDA kernels (not the plain versions): forward, and
# backward.
LAUNCHES = 0
BWD_LAUNCHES = 0

HEAD_DIMS = (32, 64, 96, 128)  # the instantiations in csrc/flash_attention*.cu

_SIGNATURES = {
    "vt_flash_attention_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
    + [ctypes.c_float, ctypes.c_void_p],
}
_BWD_SIGNATURES = {
    "vt_flash_attention_bwd": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
    + [ctypes.c_float, ctypes.c_void_p],
    "vt_flash_bwd_row_floats": [ctypes.c_int] * 2,
    "vt_flash_bwd_scratch_floats": [ctypes.c_int] * 4,
}


def _forward_reference(q, k, v, scale):
    """Plain forward: (o in q's dtype, lse fp32 (B, H, Nq))."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul((p / l).to(v.dtype).float(), v.float()).to(q.dtype)
    return o, (m + torch.log(l)).squeeze(-1)


def flash_attention_reference(q, k, v, scale):
    """The plain forward alone (no autograd of its own rounding order)."""
    return _forward_reference(q, k, v, scale)[0]


def flash_attention_backward_reference(q, k, v, o, lse, do, scale):
    """Plain backward in the kernels' order (module doc): (dq, dk, dv)."""
    rnd = lambda t: t.to(q.dtype).float()
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale
                  - lse.float()[..., None])
    dv = torch.matmul(rnd(p).transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = rnd(p * (dp - delta) * scale)
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, scale):
        if q.device.type == "cpu":
            o, lse = _forward_reference(q, k, v, scale)
        else:
            o, lse = _launch(q, k, v, scale)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.device.type == "cpu":
            grads = flash_attention_backward_reference(q, k, v, o, lse, do,
                                                       ctx.scale)
        else:
            grads = _launch_backward(q, k, v, o, lse, do.contiguous(),
                                     ctx.scale)
        return (*grads, None)


def flash_attention(q, k, v, scale):
    """softmax(q kᵀ · scale) v; q (B, H, Nq, hd), k and v (B, H, Nkv, hd)."""
    return _FlashAttention.apply(q, k, v, scale)


def _check_shapes(name, q, k, v, scale):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)} are not (B, H, N, hd) alike")
    B, H, Nq, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} is not one of {HEAD_DIMS}")
    if Nq < 1 or k.shape[2] < 1:
        raise ValueError(f"{name}: empty sequence")
    if not scale > 0:
        raise ValueError(f"{name}: scale {scale} is not positive")
    return B * H, Nq, k.shape[2], hd


def _launch(q, k, v, scale, lib=None):
    """(o, lse) from the forward kernel; ``lib`` is another build of it
    (``_build.load``), to compare designs."""
    global LAUNCHES
    name = "flash_attention"
    _build.check_operands(name, q=q, k=k, v=v)
    BH, Nq, Nkv, hd = _check_shapes(name, q, k, v, scale)
    if lib is None:
        lib = _build.load("flash_attention", _SIGNATURES)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    P = _build.ptr
    status = lib.vt_flash_attention_fwd(P(q), P(k), P(v), P(o), P(lse), BH,
                                        Nq, Nkv, hd, float(scale),
                                        _build.stream_handle())
    _build.check_status(name, status)
    LAUNCHES += 1
    return o, lse


def _launch_backward(q, k, v, o, lse, do, scale, lib=None):
    """(dq, dk, dv) from the backward kernels; ``lib`` as in ``_launch``."""
    global BWD_LAUNCHES
    name = "flash_attention backward"
    _build.check_operands(name, q=q, k=k, v=v, o=o, do=do)
    BH, Nq, Nkv, hd = _check_shapes(name, q, k, v, scale)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != q.shape[:3] \
            or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"{name}: o {tuple(o.shape)}, do {tuple(do.shape)} "
                         f"or lse {tuple(lse.shape)} {lse.dtype} do not fit "
                         f"q {tuple(q.shape)}")
    if lib is None:
        lib = _build.load("flash_attention_bwd", _BWD_SIGNATURES)
    n_rows = lib.vt_flash_bwd_row_floats(BH, Nq)
    n_scratch = lib.vt_flash_bwd_scratch_floats(BH, Nq, Nkv, hd)
    if n_rows < 0 or n_scratch < 0:
        raise ValueError(f"{name}: scratch for {BH} x ({Nq}, {Nkv}) x {hd} "
                         f"is too large")
    dev = q.device
    f32 = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    rows, scratch = f32(n_rows), f32(n_scratch)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    P = _build.ptr
    status = lib.vt_flash_attention_bwd(
        P(q), P(k), P(v), P(o), P(lse), P(do), P(rows), P(scratch), P(dq),
        P(dk), P(dv), BH, Nq, Nkv, hd, float(scale), _build.stream_handle())
    _build.check_status(name, status)
    BWD_LAUNCHES += 1
    return dq, dk, dv
