"""Plain PyTorch pieces shared by the kernels' plain versions."""

import torch


def layer_norm(x, weight, bias, eps):
    """LayerNorm with fp32 statistics, rounded to ``x.dtype``: the order of
    the TPU kernels (fused_mhsa_pallas.py:141-146, fused_ffn_pallas.py:68-73)
    and of ``csrc/layernorm.cuh``."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    xn = (xf - mean) * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return xn.to(x.dtype)


def linear_fp32(x, weight, bias):
    """``x · weightᵀ + bias`` accumulated in fp32 (weight in nn.Linear's
    (out, in) layout), left in fp32 for the caller to round."""
    return torch.matmul(x.float(), weight.float().t()) + bias.float()
