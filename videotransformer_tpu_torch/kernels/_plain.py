"""Plain PyTorch pieces shared by the kernels' plain versions."""

import torch


def _normalize(x, eps):
    """(xhat, rstd) of the rows of x, fp32 statistics."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return (xf - mean) * rstd, rstd


def layer_norm_fp32(x, weight, bias, eps):
    """LayerNorm with fp32 statistics, left in fp32."""
    xhat, _ = _normalize(x, eps)
    return xhat * weight.float() + bias.float()


def layer_norm(x, weight, bias, eps):
    """LayerNorm with fp32 statistics, rounded to ``x.dtype``: the order of
    the TPU kernels (fused_mhsa_pallas.py:141-146, fused_ffn_pallas.py:68-73)
    and of ``csrc/layernorm.cuh``."""
    return layer_norm_fp32(x, weight, bias, eps).to(x.dtype)


def layer_norm_backward(dxn, x, weight, eps):
    """fp32 LayerNorm backward of the rows of x from the fp32 gradient of
    its output (fused_mhsa_pallas.py:403-411, fused_ffn_pallas.py:213-219):
    (dx, dweight, dbias), dx in fp32 for the caller to round."""
    xhat, rstd = _normalize(x, eps)
    dxhat = dxn * weight.float()
    dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return dx, (dxn * xhat).sum(0), dxn.sum(0)


def linear_fp32(x, weight, bias):
    """``x · weightᵀ + bias`` accumulated in fp32 (weight in nn.Linear's
    (out, in) layout), left in fp32 for the caller to round."""
    return torch.matmul(x.float(), weight.float().t()) + bias.float()
