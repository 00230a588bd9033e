"""Transformer building blocks of divided space-time TimeSformer, eval path.

Port of ``videotransformer_tpu/ops/blocks.py``. Module and parameter names
are the original PyTorch repo's, i.e. what
``videotransformer_tpu.models.convert.flax_to_torch_state_dict`` emits, so a
converted state dict loads with ``strict=True``.

The prenorm attentions and the FFN call the two fused kernels
(``kernels.fused_mhsa``, ``kernels.fused_ffn``): on a CUDA tensor these
launch the hand-written kernels, on a CPU tensor they run the kernels' plain
versions. Eval only: Dropout and DropPath are the identity at inference and
come with the training port.

Weights are held in the working type (``model.to(torch.bfloat16)`` casts
them once, at load). The JAX package keeps fp32 parameters and casts them
to the working type on every use (blocks.py:318-323); the values the kernels
see are the same.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from videotransformer_tpu_torch.kernels import fused_ffn, fused_mhsa
from videotransformer_tpu_torch.ops import initializers as init

LN_EPS = 1e-5  # LayerNorm eps inside the blocks (torch's default)


def get_sine_cosine_pos_emb(n_position, d_hid):
    """Sinusoid position table (1, n_position, d_hid) in fp32, computed in
    float64 like the reference (transformer.py:12-22)."""
    position = np.arange(n_position)[:, None]
    hid = np.arange(d_hid)[None, :]
    angle = position / np.power(10000, 2 * (hid // 2) / d_hid)
    table = np.zeros((n_position, d_hid), dtype=np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return torch.tensor(table[None], dtype=torch.float32)


def _reset_layer_norm(norm):
    init.ones_(norm.weight)
    init.zeros_(norm.bias)


class Attention(nn.Module):
    """Parameter holder of the fused-QKV MHSA (names ``qkv``, ``proj``); the
    computation is ``fused_mhsa.fused_prenorm_mhsa``."""

    def __init__(self, dim, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def reset_parameters(self, generator):
        init.torch_linear_(self.qkv, generator)
        init.torch_linear_(self.proj, generator)


class _PrenormMHSA(nn.Module):
    """LayerNorm + Attention, run as one fused prenorm-MHSA call."""

    def __init__(self, embed_dims, num_heads):
        super().__init__()
        self.norm = nn.LayerNorm(embed_dims, eps=LN_EPS)
        self.attn = Attention(embed_dims, num_heads)

    def reset_parameters(self, generator):
        _reset_layer_norm(self.norm)
        self.attn.reset_parameters(generator)

    def _prenorm_mhsa(self, x, block_diag=0):
        a = self.attn
        head_dim = a.qkv.weight.shape[0] // 3 // a.num_heads
        return fused_mhsa.fused_prenorm_mhsa(
            x.contiguous(), self.norm.weight, self.norm.bias, a.qkv.weight,
            a.qkv.bias, a.proj.weight, a.proj.bias, a.num_heads,
            head_dim ** -0.5, LN_EPS, False, block_diag)


class DividedTemporalAttention(_PrenormMHSA):
    """Temporal half of divided space-time attention (blocks.py:227-344).

    Strip the cls token, fold ``b (p t) d -> (b p) t d`` (a pure reshape of
    the patch-major layout), prenorm MHSA over each length-t row, then
    ``temporal_fc`` (zero-initialised) when the cls token is absent, the
    residual, and the cls token re-attached. Each length-t row is its own
    sequence: the kernel's ``block_diag`` mode with T = the row length."""

    def __init__(self, embed_dims, num_heads, num_frames, use_cls_token):
        super().__init__(embed_dims, num_heads)
        self.num_frames = num_frames
        self.use_cls_token = use_cls_token
        if not use_cls_token:
            self.temporal_fc = nn.Linear(embed_dims, embed_dims)

    def reset_parameters(self, generator):
        super().reset_parameters(generator)
        if not self.use_cls_token:
            init.zeros_(self.temporal_fc.weight)
            init.zeros_(self.temporal_fc.bias)

    def forward(self, query):
        cls_token = query[:, :1]
        patches = query[:, 1:]
        b, n, d = patches.shape
        t = self.num_frames
        p = n // t
        x = patches.reshape(b * p, t, d)
        if self.use_cls_token:
            cls_rep = cls_token[:, None].expand(b, p, 1, d).reshape(b * p, 1, d)
            x = torch.cat([cls_rep, x], dim=1)
        attn_out = self._prenorm_mhsa(x, block_diag=x.shape[1])
        if self.use_cls_token:
            new_cls = attn_out[:, 0].reshape(b, p, d).mean(dim=1, keepdim=True)
            out = torch.cat([new_cls, attn_out[:, 1:].reshape(b, p * t, d)],
                            dim=1)
            return query + out
        attn_out = self.temporal_fc(attn_out)
        return torch.cat([cls_token, patches + attn_out.reshape(b, p * t, d)],
                         dim=1)


class DividedSpatialAttention(_PrenormMHSA):
    """Spatial half of divided space-time attention (blocks.py:347-450):
    fold ``b (p t) d -> (b t) p d``; the cls token, when present, is
    replicated per frame, attends with the patches, and is averaged back
    over frames."""

    def __init__(self, embed_dims, num_heads, num_frames, use_cls_token):
        super().__init__(embed_dims, num_heads)
        self.num_frames = num_frames
        self.use_cls_token = use_cls_token

    def forward(self, query):
        cls_token = query[:, :1]
        patches = query[:, 1:]
        b, n, d = patches.shape
        t = self.num_frames
        p = n // t
        x = patches.reshape(b, p, t, d).transpose(1, 2).reshape(b * t, p, d)
        if self.use_cls_token:
            cls_rep = cls_token[:, None].expand(b, t, 1, d).reshape(b * t, 1, d)
            x = torch.cat([cls_rep, x], dim=1)
        attn_out = self._prenorm_mhsa(x)
        if self.use_cls_token:
            new_cls = attn_out[:, 0].reshape(b, t, d).mean(dim=1, keepdim=True)
            attn_out = attn_out[:, 1:]
        out = attn_out.reshape(b, t, p, d).transpose(1, 2).reshape(b, p * t, d)
        if self.use_cls_token:
            return query + torch.cat([new_cls, out], dim=1)
        return torch.cat([cls_token, patches + out], dim=1)


class FFN(nn.Module):
    """Prenorm MLP with residual (blocks.py:525-603), two layers, run as one
    fused prenorm-FFN call. ``layers`` keeps the reference's layout:
    ``Sequential(Linear)`` then a bare ``Linear``."""

    def __init__(self, embed_dims, hidden_channels):
        super().__init__()
        self.norm = nn.LayerNorm(embed_dims, eps=LN_EPS)
        self.layers = nn.ModuleList([
            nn.Sequential(nn.Linear(embed_dims, hidden_channels)),
            nn.Linear(hidden_channels, embed_dims),
        ])

    def reset_parameters(self, generator):
        _reset_layer_norm(self.norm)
        init.torch_linear_(self.layers[0][0], generator)
        init.torch_linear_(self.layers[1], generator)

    def forward(self, x):
        fc1, fc2 = self.layers[0][0], self.layers[1]
        return x + fused_ffn.fused_prenorm_ffn(
            x.contiguous(), self.norm.weight, self.norm.bias, fc1.weight,
            fc1.bias, fc2.weight, fc2.bias, LN_EPS)


class BasicTransformerBlock(nn.Module):
    """One block assembled from ``operator_order`` (blocks.py:606-691), with
    ``use_cls_token = (i == len(operator_order) - 2)``: only the attention
    just before the FFN carries the cls token."""

    def __init__(self, embed_dims, num_heads, num_frames, hidden_channels,
                 operator_order):
        super().__init__()
        attentions, ffns = [], []
        order = tuple(operator_order)
        kinds = {"time_attn": DividedTemporalAttention,
                 "space_attn": DividedSpatialAttention}
        for i, op in enumerate(order):
            if op in kinds:
                attentions.append(kinds[op](
                    embed_dims, num_heads, num_frames,
                    use_cls_token=(i == len(order) - 2)))
            elif op == "ffn":
                ffns.append(FFN(embed_dims, hidden_channels))
            elif op == "self_attn":
                raise NotImplementedError(
                    "joint attention ('self_attn') is not ported yet")
            else:
                raise TypeError(f"Unsupported operator type {op}")
        self.attentions = nn.ModuleList(attentions)
        self.ffns = nn.ModuleList(ffns)

    def reset_parameters(self, generator):
        for m in (*self.attentions, *self.ffns):
            m.reset_parameters(generator)

    def forward(self, x):
        for layer in self.attentions:
            x = layer(x)
        for layer in self.ffns:
            x = layer(x)
        return x


class TransformerContainer(nn.Module):
    """Stack of BasicTransformerBlocks (blocks.py:694-740), eval path."""

    def __init__(self, num_transformer_layers, embed_dims, num_heads,
                 num_frames, hidden_channels, operator_order):
        super().__init__()
        self.layers = nn.ModuleList([
            BasicTransformerBlock(embed_dims, num_heads, num_frames,
                                  hidden_channels, operator_order)
            for _ in range(num_transformer_layers)])

    def reset_parameters(self, generator):
        for layer in self.layers:
            layer.reset_parameters(generator)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class _PatchProjection(nn.Module):
    """Conv2d-shaped weight (out, in, kh, kw) applied as one matmul: with
    kernel == stride the convolution is a reshape and a product."""

    def __init__(self, in_channels, embed_dims, patch_size):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            embed_dims, in_channels, patch_size, patch_size))
        self.bias = nn.Parameter(torch.empty(embed_dims))

    def reset_parameters(self, generator):
        init.kaiming_normal_fan_in_relu_(self.weight, generator)
        init.zeros_(self.bias)

    def forward(self, patches):
        return F.linear(patches, self.weight.reshape(self.weight.shape[0], -1),
                        self.bias)


class PatchEmbed(nn.Module):
    """Per-frame 16x16 patch embedding (blocks.py:769-804, Conv2d case):
    (b, t, c, h, w) -> (b·t, gh·gw, embed_dims)."""

    def __init__(self, img_size, patch_size, in_channels=3, embed_dims=768):
        super().__init__()
        self.img_size = img_size
        self.patch_size = patch_size
        self.projection = _PatchProjection(in_channels, embed_dims,
                                           patch_size)

    @property
    def num_patches(self):
        return (self.img_size // self.patch_size) ** 2

    def reset_parameters(self, generator):
        self.projection.reset_parameters(generator)

    def forward(self, x):
        b, t, c, h, w = x.shape
        ps = self.patch_size
        gh, gw = h // ps, w // ps
        # (b t, c, gh, ps, gw, ps) -> (b t, gh gw, c·ps·ps), the flattening
        # order of the conv weight's (in, kh, kw)
        x = x.reshape(b * t, c, gh, ps, gw, ps).permute(0, 2, 4, 1, 3, 5)
        return self.projection(x.reshape(b * t, gh * gw, c * ps * ps))


class ClassificationHead(nn.Module):
    """Linear classifier head (blocks.py:820-844)."""

    def __init__(self, num_classes, in_channels):
        super().__init__()
        self.cls_head = nn.Linear(in_channels, num_classes)

    def reset_parameters(self, generator):
        init.trunc_normal_(self.cls_head.weight, generator, std=0.02)
        init.zeros_(self.cls_head.bias)

    def forward(self, x):
        return self.cls_head(x)
