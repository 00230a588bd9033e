"""The arithmetic of the references: exact float32, or the control.

``Exact`` runs every product in float32 with TF32 off. ``Fp8`` is the
control for a configuration that states bf16 compute: the nearest
precision below it, float8. Every product's operands are rounded to
float8 with a per-tensor scale (the largest magnitude onto the format's
largest value), e4m3 for activations and weights in the forward and e5m2
for the gradients in the backward, and the products accumulate in
float32, as an fp8 training recipe runs them. Everything else (norms,
softmax, the loss, the optimizer) stays float32.
"""

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


@contextlib.contextmanager
def no_tf32():
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    before = (mm.allow_tf32, cudnn.allow_tf32)
    mm.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_tf32, cudnn.allow_tf32 = before


def quantize(x, fmt):
    """x rounded to float8 ``fmt`` under a per-tensor scale, back in x's
    dtype."""
    top = E4M3_MAX if fmt is torch.float8_e4m3fn else E5M2_MAX
    amax = x.detach().abs().amax().float().clamp(min=1e-12)
    scale = top / amax
    return ((x.float() * scale).clamp(-top, top).to(fmt).float()
            / scale).to(x.dtype)


class _Fp8Matmul(torch.autograd.Function):
    """a @ b with e4m3 operands forward and e5m2 gradients backward."""

    @staticmethod
    def forward(ctx, a, b):
        qa = quantize(a, torch.float8_e4m3fn)
        qb = quantize(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = quantize(g, torch.float8_e5m2)
        da = torch.matmul(qg, qb.transpose(-1, -2))
        db = torch.matmul(qa.transpose(-1, -2), qg)
        # undo broadcasting over leading dims
        while da.dim() > qa.dim():
            da = da.sum(0)
        while db.dim() > qb.dim():
            db = db.sum(0)
        for i, n in enumerate(qa.shape):
            if n == 1 and da.shape[i] != 1:
                da = da.sum(i, keepdim=True)
        for i, n in enumerate(qb.shape):
            if n == 1 and db.shape[i] != 1:
                db = db.sum(i, keepdim=True)
        return da, db


class Exact:
    """float32 products, TF32 off (entered by the caller with
    ``no_tf32``)."""

    name = "fp32"

    def matmul(self, a, b):
        return torch.matmul(a, b)

    def linear(self, x, w, b=None):
        return F.linear(x, w, b)

    def conv3d(self, x, w, stride, padding, groups=1, bias=None):
        return F.conv3d(x, w, bias, stride, padding, 1, groups)


class Fp8(Exact):
    """The control: the products' operands in float8 (module doc)."""

    name = "fp8"

    def matmul(self, a, b):
        return _Fp8Matmul.apply(a, b)

    def linear(self, x, w, b=None):
        y = _Fp8Matmul.apply(x, w.t())
        return y if b is None else y + b

    def conv3d(self, x, w, stride, padding, groups=1, bias=None):
        qx = x + (quantize(x, torch.float8_e4m3fn) - x).detach()
        qw = w + (quantize(w, torch.float8_e4m3fn) - w).detach()
        return F.conv3d(qx, qw, bias, stride, padding, 1, groups)


def policy(name):
    return {"fp32": Exact, "fp8": Fp8}[name]()
