"""Weight initializers matching the original PyTorch repo's distributions,
drawn from an explicit ``torch.Generator``.

Port of ``videotransformer_tpu/ops/initializers.py``. Tensors are in
PyTorch's own layouts here ((out, in) for Linear, (out, in, kh, kw) for
Conv2d), so fan-in is read from dimension 1 onward. Draws happen in place
under ``torch.no_grad``; the generator must live on the tensor's device.
"""

import math

import torch


@torch.no_grad()
def torch_linear_(linear, generator):
    """nn.Linear's default: weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(linear.weight.shape[1])
    linear.weight.uniform_(-bound, bound, generator=generator)
    if linear.bias is not None:
        linear.bias.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def trunc_normal_(tensor, generator, std=0.02, mean=0.0, a=-2.0, b=2.0):
    """Inverse-CDF truncated normal on [a, b] (weight_init.py:31-62)."""

    def norm_cdf(x):
        return (1.0 + math.erf(x / math.sqrt(2.0))) / 2.0

    lo = norm_cdf((a - mean) / std)
    hi = norm_cdf((b - mean) / std)
    tensor.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
    tensor.erfinv_()
    tensor.mul_(std * math.sqrt(2.0)).add_(mean)
    tensor.clamp_(a, b)


@torch.no_grad()
def kaiming_normal_fan_in_relu_(tensor, generator):
    """kaiming_normal_(mode='fan_in', nonlinearity='relu') for a conv weight
    (out, in, *kernel): std = sqrt(2 / (in * prod(kernel)))."""
    fan_in = tensor[0].numel()
    tensor.normal_(0.0, math.sqrt(2.0) / math.sqrt(fan_in), generator=generator)


@torch.no_grad()
def xavier_uniform_flat_(tensor, generator):
    """xavier_uniform on the (out, flattened-in) view (MaskFeat's patch embed
    and decoder, video_transformer.py:860-861): U(-b, b) with b =
    sqrt(6 / (fan_in + fan_out)), fan_in = in · prod(kernel), fan_out = out."""
    bound = math.sqrt(6.0 / (tensor[0].numel() + tensor.shape[0]))
    tensor.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def normal_(tensor, generator, std=0.01):
    tensor.normal_(0.0, std, generator=generator)


@torch.no_grad()
def zeros_(tensor):
    tensor.zero_()


@torch.no_grad()
def ones_(tensor):
    tensor.fill_(1.0)
