"""Transformer building blocks of TimeSformer and ViViT: divided and joint
space-time attention, the FFN, the per-frame and tubelet patch embeddings.

Port of ``videotransformer_tpu/ops/blocks.py``. Module and parameter names
are the original PyTorch repo's, i.e. what
``videotransformer_tpu.models.convert.flax_to_torch_state_dict`` emits, so a
converted state dict loads with ``strict=True``.

The prenorm attentions and the FFN call the two fused kernels
(``kernels.fused_mhsa``, ``kernels.fused_ffn``), forward and backward: on a
CUDA tensor these launch the hand-written kernels, on a CPU tensor they run
the kernels' plain versions. Joint attention over more than 2048 tokens
takes the unfused form the JAX package takes there, its core the flash
attention kernel (``kernels.flash_attention``).

The working type is the activations' dtype. Every parameter is cast to it
at its use, as the JAX package casts its fp32 parameters
(blocks.py:318-323): training keeps fp32 parameters and feeds bf16 clips;
serving casts the model to bf16 once, and the casts are then no-ops.

DropPath (stochastic depth) acts in training mode only, with the keep mask
over the leading axis of the tensor it is applied to (blocks.py:61-79): one
draw per ``(b·p)`` temporal row, per ``(b·t)`` spatial row and per sample in
the FFN, placed where the JAX blocks place it (blocks.py:331-334, 433-434,
602). Its uniforms come from the ``generator`` passed down the forward.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from videotransformer_tpu_torch.kernels import (
    flash_attention, fused_ffn, fused_mhsa)
from videotransformer_tpu_torch.kernels._plain import layer_norm
from videotransformer_tpu_torch.ops import initializers as init

LN_EPS = 1e-5  # LayerNorm eps inside the blocks (torch's default)
# the longest sequence the JAX package gives its fused prenorm-MHSA kernel
# (blocks.py:210-224); joint attention over more tokens goes unfused
FUSED_MHSA_MAX_N = 2048


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


def drop_path(x, rate, generator):
    """Stochastic depth per leading-axis row (blocks.py:61-79):
    ``x / keep · floor(keep + U)``, U uniform in the working type."""
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    u = torch.rand(shape, generator=generator, dtype=x.dtype, device=x.device)
    return x / keep * torch.floor(keep + u)


class DropPath(nn.Module):
    """Stochastic depth at ``rate``; the identity in eval mode or at 0."""

    def __init__(self, rate=0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, generator=None):
        if not self.training or self.rate == 0.0:
            return x
        return drop_path(x, self.rate, generator)


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
    """LayerNorm + Attention, run as one fused prenorm-MHSA call, then
    DropPath on its output."""

    def __init__(self, embed_dims, num_heads, drop_path_rate=0.0):
        super().__init__()
        self.norm = nn.LayerNorm(embed_dims, eps=LN_EPS)
        self.attn = Attention(embed_dims, num_heads)
        self.layer_drop = DropPath(drop_path_rate)

    def reset_parameters(self, generator):
        _reset_layer_norm(self.norm)
        self.attn.reset_parameters(generator)

    def _prenorm_mhsa(self, x, generator, block_diag=0):
        a = self.attn
        dt = x.dtype
        head_dim = a.qkv.weight.shape[0] // 3 // a.num_heads
        out = fused_mhsa.fused_prenorm_mhsa(
            x.contiguous(), self.norm.weight.to(dt), self.norm.bias.to(dt),
            a.qkv.weight.to(dt), a.qkv.bias.to(dt), a.proj.weight.to(dt),
            a.proj.bias.to(dt), a.num_heads, head_dim ** -0.5, LN_EPS, False,
            block_diag)
        return self.layer_drop(out, generator)


class JointAttention(_PrenormMHSA):
    """Prenorm joint space-time MHSA with the residual (blocks.py:453-522):
    every token of the clip attends to every other, DropPath per sample.

    Up to FUSED_MHSA_MAX_N tokens it is one fused prenorm-MHSA call (B1
    forward, B3 backward), as in the JAX package from N = 64; the port
    sends N < 64 there too (the fact_encoder's temporal stack, N = 9),
    where the JAX package takes a VPU path that is not ported. Above it,
    the JAX package's unfused ``Attention``: LayerNorm (fp32 statistics),
    the qkv product, flash attention (B5 forward, B6 backward) on (B, H,
    N, hd), the projection."""

    def forward(self, query, generator=None):
        if query.shape[1] <= FUSED_MHSA_MAX_N:
            return query + self._prenorm_mhsa(query, generator)
        return query + self.layer_drop(self._unfused(query), generator)

    def _unfused(self, x):
        a = self.attn
        dt = x.dtype
        B, N, D = x.shape
        hd = D // a.num_heads
        xn = layer_norm(x, self.norm.weight, self.norm.bias, LN_EPS)
        qkv = F.linear(xn, a.qkv.weight.to(dt), a.qkv.bias.to(dt))
        q, k, v = qkv.reshape(B, N, 3, a.num_heads, hd).permute(
            2, 0, 3, 1, 4).contiguous().unbind(0)
        o = flash_attention.flash_attention(q, k, v, hd ** -0.5)
        o = o.transpose(1, 2).reshape(B, N, D)
        return F.linear(o, a.proj.weight.to(dt), a.proj.bias.to(dt))


class DividedTemporalAttention(_PrenormMHSA):
    """Temporal half of divided space-time attention (blocks.py:227-344).

    Strip the cls token, fold ``b (p t) d -> (b p) t d`` (a pure reshape of
    the patch-major layout), prenorm MHSA over each length-t row, DropPath
    per row, then ``temporal_fc`` (zero-initialised) when the cls token is
    absent, the residual, and the cls token re-attached. Each length-t row
    is its own sequence: the kernel's ``block_diag`` mode with T = the row
    length."""

    def __init__(self, embed_dims, num_heads, num_frames, use_cls_token,
                 drop_path_rate=0.0):
        super().__init__(embed_dims, num_heads, drop_path_rate)
        self.num_frames = num_frames
        self.use_cls_token = use_cls_token
        if not use_cls_token:
            self.temporal_fc = nn.Linear(embed_dims, embed_dims)

    def reset_parameters(self, generator):
        super().reset_parameters(generator)
        if not self.use_cls_token:
            init.zeros_(self.temporal_fc.weight)
            init.zeros_(self.temporal_fc.bias)

    def forward(self, query, generator=None):
        cls_token = query[:, :1]
        patches = query[:, 1:]
        b, n, d = patches.shape
        t = self.num_frames
        p = n // t
        x = patches.reshape(b * p, t, d)
        if self.use_cls_token:
            cls_rep = cls_token[:, None].expand(b, p, 1, d).reshape(b * p, 1, d)
            x = torch.cat([cls_rep, x], dim=1)
        attn_out = self._prenorm_mhsa(x, generator, block_diag=x.shape[1])
        if self.use_cls_token:
            new_cls = attn_out[:, 0].reshape(b, p, d).mean(dim=1, keepdim=True)
            out = torch.cat([new_cls, attn_out[:, 1:].reshape(b, p * t, d)],
                            dim=1)
            return query + out
        fc = self.temporal_fc
        attn_out = F.linear(attn_out, fc.weight.to(query.dtype),
                            fc.bias.to(query.dtype))
        return torch.cat([cls_token, patches + attn_out.reshape(b, p * t, d)],
                         dim=1)


class DividedSpatialAttention(_PrenormMHSA):
    """Spatial half of divided space-time attention (blocks.py:347-450):
    fold ``b (p t) d -> (b t) p d``; the cls token, when present, is
    replicated per frame, attends with the patches, and is averaged back
    over frames. DropPath is per length-p (or p + 1) row."""

    def __init__(self, embed_dims, num_heads, num_frames, use_cls_token,
                 drop_path_rate=0.0):
        super().__init__(embed_dims, num_heads, drop_path_rate)
        self.num_frames = num_frames
        self.use_cls_token = use_cls_token

    def forward(self, query, generator=None):
        cls_token = query[:, :1]
        patches = query[:, 1:]
        b, n, d = patches.shape
        t = self.num_frames
        p = n // t
        x = patches.reshape(b, p, t, d).transpose(1, 2).reshape(b * t, p, d)
        if self.use_cls_token:
            cls_rep = cls_token[:, None].expand(b, t, 1, d).reshape(b * t, 1, d)
            x = torch.cat([cls_rep, x], dim=1)
        attn_out = self._prenorm_mhsa(x, generator)
        if self.use_cls_token:
            new_cls = attn_out[:, 0].reshape(b, t, d).mean(dim=1, keepdim=True)
            attn_out = attn_out[:, 1:]
        out = attn_out.reshape(b, t, p, d).transpose(1, 2).reshape(b, p * t, d)
        if self.use_cls_token:
            return query + torch.cat([new_cls, out], dim=1)
        return torch.cat([cls_token, patches + out], dim=1)


class FFN(nn.Module):
    """Prenorm MLP with residual (blocks.py:525-603), two layers, run as one
    fused prenorm-FFN call, DropPath per sample on its output. ``layers``
    keeps the reference's layout: ``Sequential(Linear)`` then a bare
    ``Linear``."""

    def __init__(self, embed_dims, hidden_channels, drop_path_rate=0.0):
        super().__init__()
        self.norm = nn.LayerNorm(embed_dims, eps=LN_EPS)
        self.layers = nn.ModuleList([
            nn.Sequential(nn.Linear(embed_dims, hidden_channels)),
            nn.Linear(hidden_channels, embed_dims),
        ])
        self.layer_drop = DropPath(drop_path_rate)

    def reset_parameters(self, generator):
        _reset_layer_norm(self.norm)
        init.torch_linear_(self.layers[0][0], generator)
        init.torch_linear_(self.layers[1], generator)

    def forward(self, x, generator=None):
        fc1, fc2 = self.layers[0][0], self.layers[1]
        dt = x.dtype
        out = fused_ffn.fused_prenorm_ffn(
            x.contiguous(), self.norm.weight.to(dt), self.norm.bias.to(dt),
            fc1.weight.to(dt), fc1.bias.to(dt), fc2.weight.to(dt),
            fc2.bias.to(dt), LN_EPS)
        return x + self.layer_drop(out, generator)


class BasicTransformerBlock(nn.Module):
    """One block assembled from ``operator_order`` (blocks.py:606-691):
    ``self_attn`` (joint), ``time_attn`` and ``space_attn`` (divided),
    ``ffn``, with ``use_cls_token = (i == len(operator_order) - 2)``: only
    the divided attention just before the FFN carries the cls token."""

    def __init__(self, embed_dims, num_heads, num_frames, hidden_channels,
                 operator_order, drop_path_rate=0.0):
        super().__init__()
        attentions, ffns = [], []
        order = tuple(operator_order)
        kinds = {"time_attn": DividedTemporalAttention,
                 "space_attn": DividedSpatialAttention}
        for i, op in enumerate(order):
            if op in kinds:
                attentions.append(kinds[op](
                    embed_dims, num_heads, num_frames,
                    use_cls_token=(i == len(order) - 2),
                    drop_path_rate=drop_path_rate))
            elif op == "self_attn":
                attentions.append(JointAttention(embed_dims, num_heads,
                                                 drop_path_rate))
            elif op == "ffn":
                ffns.append(FFN(embed_dims, hidden_channels, drop_path_rate))
            else:
                raise TypeError(f"Unsupported operator type {op}")
        self.attentions = nn.ModuleList(attentions)
        self.ffns = nn.ModuleList(ffns)

    def reset_parameters(self, generator):
        for m in (*self.attentions, *self.ffns):
            m.reset_parameters(generator)

    def forward(self, x, generator=None):
        for layer in self.attentions:
            x = layer(x, generator)
        for layer in self.ffns:
            x = layer(x, generator)
        return x


class TransformerContainer(nn.Module):
    """Stack of BasicTransformerBlocks (blocks.py:694-740) with the DropPath
    rate of layer i at ``linspace(0, drop_path_rate, depth)[i]``."""

    def __init__(self, num_transformer_layers, embed_dims, num_heads,
                 num_frames, hidden_channels, operator_order,
                 drop_path_rate=0.0):
        super().__init__()
        dpr = np.linspace(0, drop_path_rate, num_transformer_layers)
        self.layers = nn.ModuleList([
            BasicTransformerBlock(embed_dims, num_heads, num_frames,
                                  hidden_channels, operator_order,
                                  float(dpr[i]))
            for i in range(num_transformer_layers)])

    def reset_parameters(self, generator):
        for layer in self.layers:
            layer.reset_parameters(generator)

    def forward(self, x, generator=None):
        for layer in self.layers:
            x = layer(x, generator)
        return x


class _PatchProjection(nn.Module):
    """Conv-shaped weight, (out, in, kh, kw) or (out, in, kt, kh, kw),
    applied as one matmul: with kernel == stride the convolution is a
    reshape and a product."""

    def __init__(self, in_channels, embed_dims, kernel):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            embed_dims, in_channels, *kernel))
        self.bias = nn.Parameter(torch.empty(embed_dims))

    def reset_parameters(self, generator):
        init.kaiming_normal_fan_in_relu_(self.weight, generator)
        init.zeros_(self.bias)

    def forward(self, patches):
        w = self.weight.reshape(self.weight.shape[0], -1)
        return F.linear(patches, w.to(patches.dtype),
                        self.bias.to(patches.dtype))


class PatchEmbed(nn.Module):
    """Patch embedding (blocks.py:769-815): ``Conv2d``, per-frame ps x ps
    patches, (b, t, c, h, w) -> (b·t, gh·gw, embed_dims); ``Conv3d``,
    tube_size x ps x ps tubelets, -> (b·t/tube_size, gh·gw, embed_dims)."""

    def __init__(self, img_size, patch_size, in_channels=3, embed_dims=768,
                 tube_size=2, conv_type="Conv2d"):
        super().__init__()
        if conv_type not in ("Conv2d", "Conv3d"):
            raise TypeError(f"Unsupported conv layer type {conv_type}")
        self.img_size = img_size
        self.patch_size = patch_size
        self.tube_size = tube_size if conv_type == "Conv3d" else 1
        kernel = (patch_size, patch_size)
        if conv_type == "Conv3d":
            kernel = (tube_size,) + kernel
        self.projection = _PatchProjection(in_channels, embed_dims, kernel)

    @property
    def num_patches(self):
        return (self.img_size // self.patch_size) ** 2

    def reset_parameters(self, generator):
        self.projection.reset_parameters(generator)

    def forward(self, x):
        b, t, c, h, w = x.shape
        ps, tt = self.patch_size, self.tube_size
        gh, gw, gt = h // ps, w // ps, t // tt
        # (b gt, tt, c, gh, ps, gw, ps) -> (b gt, gh gw, c·tt·ps·ps), the
        # flattening order of the conv weight's (in, [kt,] kh, kw)
        x = x.reshape(b * gt, tt, c, gh, ps, gw, ps).permute(
            0, 3, 5, 2, 1, 4, 6)
        return self.projection(x.reshape(b * gt, gh * gw, c * tt * ps * ps))


class ClassificationHead(nn.Module):
    """Linear classifier head (blocks.py:820-844)."""

    def __init__(self, num_classes, in_channels):
        super().__init__()
        self.cls_head = nn.Linear(in_channels, num_classes)

    def reset_parameters(self, generator):
        init.trunc_normal_(self.cls_head.weight, generator, std=0.02)
        init.zeros_(self.cls_head.bias)

    def forward(self, x):
        fc = self.cls_head
        return F.linear(x, fc.weight.to(x.dtype), fc.bias.to(x.dtype))
