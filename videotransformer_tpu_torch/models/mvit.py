"""Multiscale Vision Transformers (MViT-B), the trunk of MaskFeat.

Port of ``videotransformer_tpu/models/mvit.py`` (pytorchvideo's layers as the
original repo configures them, video_transformer.py:621-800):

- ``MultiScaleAttention``: fused-QKV attention whose Q, K and V are pooled
  by a depthwise Conv3d (kernel 3³, one head-dim kernel tiled over the
  heads) and a per-head LayerNorm. The patch queries go through the flash
  attention kernel (``kernels.flash_attention``, B5 forward and B6
  backward); the single cls query row is plain math, as mvit.py:256-267.
  Each branch scales as the JAX one does: the kernel scales the scores, the
  cls row scales q.
- ``MultiScaleBlock``: prenorm attention with a MaxPool3d skip path where Q
  is strided, then the MLP: where dim == dim_out it is the fused prenorm FFN
  kernel (``kernels.fused_ffn``, B2 and B4, LayerNorm eps 1e-6) on the patch
  tokens and plain math on the cls row (mvit.py:370-395); elsewhere the
  plain MLP with fc2 widening to dim_out and a Linear ``proj`` on the
  residual.
- ``SpatioTemporalClsPositionalEncoding`` (separate spatial, temporal and
  class tables) and ``MultiscaleVisionTransformers`` (encoding, blocks,
  final LayerNorm), built by ``create_multiscale_vision_transformers`` from
  the block schedule of ``build_mvit_block_configs``.

The trunk runs in the JAX package's split-cls layout: the cls token is a
separate (B, 1, C) tensor beside the (B, L, C) patch tokens, so the pools
and the kernels see only the patch tokens, and L = T·H·W stays the flash
kernel's Nq. It is concatenated back once, before the final LayerNorm.

Module and parameter names are pytorchvideo's, those of
``videotransformer_tpu.models.convert.maskfeat_flax_to_torch_state_dict``;
the pooling convs keep the (head_dim, 1, k, k, k) weight. The working type
is the activations' dtype; fp32 parameters are cast to it at each use.
LayerNorms outside the kernels take fp32 statistics and round to the working
type, as flax's do. The convolutions and max pools are library calls
(cuDNN on the card), as they were XLA convolutions outside Pallas in the JAX
package; the max pools' backward is written out (``_MaxPool3d``) so that it
adds in a fixed order. Dropout inside the blocks is not ported (MaskFeat builds none).
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from videotransformer_tpu_torch.kernels import flash_attention, fused_ffn
from videotransformer_tpu_torch.ops import initializers as init
from videotransformer_tpu_torch.parallel import mesh as _mesh

LN_EPS = 1e-6  # every LayerNorm of the trunk (video_transformer.py:668-671)


def round_width(width, multiplier, min_width=1, divisor=1, ceil=False):
    """pytorchvideo round_width (video_transformer.py:755-761)."""
    if not multiplier:
        return width
    width *= multiplier
    min_width = min_width or divisor
    if ceil:
        width_out = max(min_width, int(math.ceil(width / divisor)) * divisor)
    else:
        width_out = max(min_width, int(width + divisor / 2) // divisor * divisor)
    if width_out < 0.9 * width:
        width_out += divisor
    return int(width_out)


def layer_norm(x, norm):
    """``norm`` (an nn.LayerNorm) with fp32 statistics, in x's dtype."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps).to(x.dtype)


def linear(x, fc):
    return F.linear(x, fc.weight.to(x.dtype),
                    None if fc.bias is None else fc.bias.to(x.dtype))


class _MaxPool3d(torch.autograd.Function):
    """MaxPool3d(ceil_mode=False) over (T, H, W) of x (B, T, H, W, C) whose
    backward adds the windows' gradients in a fixed order, in fp32.
    F.max_pool3d's CUDA backward adds them with atomics in x's dtype, so two
    runs of a training step differ (as XLA's select-and-scatter does not)."""

    @staticmethod
    def forward(ctx, x, kernel, stride, padding):
        y, idx = F.max_pool3d(x.permute(0, 4, 1, 2, 3), kernel, stride,
                              padding, return_indices=True)
        y = y.permute(0, 2, 3, 4, 1)
        if ctx.needs_input_grad[0]:
            # each output's argmax as its offset in the window, (t, h, w)
            # row-major: < 27 for the kernels MViT pools with
            T, H, W = x.shape[1:4]
            idx = idx.permute(0, 2, 3, 4, 1)
            o = [torch.arange(n, device=x.device) * s - p
                 for n, s, p in zip(y.shape[1:4], stride, padding)]
            offset = ((idx // (H * W) - o[0][:, None, None, None]) * kernel[1]
                      + idx // W % H - o[1][:, None, None]) * kernel[2] \
                + idx % W - o[2][:, None]
            ctx.save_for_backward(offset.to(torch.uint8))
            ctx.geometry = (x.shape, kernel, stride, padding)
        return y

    @staticmethod
    def backward(ctx, gy):
        (offset,) = ctx.saved_tensors
        (B, T, H, W, C), kernel, stride, padding = ctx.geometry
        out, dtype = gy.shape[1:4], gy.dtype
        g = gy.new_zeros((B, *[n + 2 * p for n, p in zip((T, H, W), padding)],
                          C), dtype=torch.float32)
        gy, zero = gy.float(), gy.new_zeros((), dtype=torch.float32)
        for i, (a, b, c) in enumerate(np.ndindex(*kernel)):
            g[:, a:a + stride[0] * (out[0] - 1) + 1:stride[0],
              b:b + stride[1] * (out[1] - 1) + 1:stride[1],
              c:c + stride[2] * (out[2] - 1) + 1:stride[2]] += torch.where(
                  offset == i, gy, zero)
        g = g[:, padding[0]:padding[0] + T, padding[1]:padding[1] + H,
              padding[2]:padding[2] + W]
        return g.to(dtype), None, None, None


def _maxpool3d(x, kernel, stride, padding):
    """x (B, T, H, W, C); MaxPool3d(ceil_mode=False) with -inf padding."""
    return _MaxPool3d.apply(x, tuple(kernel), tuple(stride), tuple(padding))


class _PoolConv(nn.Module):
    """Depthwise Conv3d(C, C, k, s, k // 2, groups=C, bias=False) over all C
    = heads · head_dim channels, with pytorchvideo's (head_dim, 1, k, k, k)
    weight tiled over the heads (mvit.py:82-116)."""

    def __init__(self, head_dim, kernel, stride):
        super().__init__()
        self.kernel = tuple(kernel)
        self.stride = tuple(stride)
        self.weight = nn.Parameter(torch.empty(head_dim, 1, *self.kernel))

    def reset_parameters(self, generator):
        init.trunc_normal_(self.weight, generator, std=0.02)

    def forward(self, x):
        """x (B, C, T, H, W) -> (B, C, T', H', W')."""
        C = x.shape[1]
        w = self.weight.to(x.dtype).repeat(C // self.weight.shape[0], 1, 1, 1, 1)
        return F.conv3d(x, w, stride=self.stride,
                        padding=[k // 2 for k in self.kernel], groups=C)


def _pool_or_none(head_dim, kernel, stride):
    if len(kernel) > 0 and int(np.prod(kernel)) > 0:
        return _PoolConv(head_dim, kernel, stride)
    return None


class MultiScaleAttention(nn.Module):
    """Pooling attention in split-cls layout (mvit.py:119-282)."""

    def __init__(self, dim, num_heads, qkv_bias=True, kernel_q=(),
                 kernel_kv=(), stride_q=(), stride_kv=()):
        super().__init__()
        self.num_heads = num_heads
        hd = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        for name, kernel, stride in (("q", kernel_q, stride_q),
                                     ("k", kernel_kv, stride_kv),
                                     ("v", kernel_kv, stride_kv)):
            pool = _pool_or_none(hd, kernel, stride)
            setattr(self, f"pool_{name}", pool)
            setattr(self, f"norm_{name}", None if pool is None
                    else nn.LayerNorm(hd, eps=LN_EPS))
        self.proj = nn.Linear(dim, dim)

    def reset_parameters(self, generator):
        for fc in (self.qkv, self.proj):
            init.trunc_normal_(fc.weight, generator, std=0.02)
            if fc.bias is not None:
                init.zeros_(fc.bias)
        for pool, norm in ((self.pool_q, self.norm_q),
                           (self.pool_k, self.norm_k),
                           (self.pool_v, self.norm_v)):
            if pool is not None:
                pool.reset_parameters(generator)
                init.ones_(norm.weight)
                init.zeros_(norm.bias)

    def _per_head_norm(self, t, norm):
        B, n, C = t.shape
        return layer_norm(t.reshape(B, n, self.num_heads, -1), norm
                          ).reshape(B, n, C)

    def _pool(self, cls_tok, t, thw, pool, norm):
        """pytorchvideo _attention_pool in split-cls layout (mvit.py:146-173):
        the conv over the patch tokens, then the per-head LayerNorm of the
        patch and cls tokens apart."""
        if pool is None:
            return cls_tok, t, thw
        B, L, C = t.shape
        u = pool(t.reshape(B, *thw, C).permute(0, 4, 1, 2, 3))
        new_thw = tuple(u.shape[2:])
        u = u.permute(0, 2, 3, 4, 1).reshape(B, -1, C)
        return (self._per_head_norm(cls_tok, norm),
                self._per_head_norm(u, norm), new_thw)

    def _heads(self, t):
        """(B, N, C) -> (B, heads, N, head_dim), contiguous for the kernel."""
        B, N, C = t.shape
        return t.reshape(B, N, self.num_heads, -1).transpose(1, 2).contiguous()

    def forward(self, x, x_cls, thw):
        """x (B, L, C) patch tokens, x_cls (B, 1, C), thw = (T, H, W) of L.
        Returns ((out_cls, out), (T', H', W') of the pooled queries)."""
        B, L, C = x.shape
        scale = (C // self.num_heads) ** -0.5
        qkv = linear(x, self.qkv)
        qkv_cls = linear(x_cls, self.qkv)
        part = lambda t, i: t[..., i * C:(i + 1) * C]
        q_cls, q, q_thw = self._pool(part(qkv_cls, 0), part(qkv, 0), thw,
                                     self.pool_q, self.norm_q)
        k_cls, k, _ = self._pool(part(qkv_cls, 1), part(qkv, 1), thw,
                                 self.pool_k, self.norm_k)
        v_cls, v, _ = self._pool(part(qkv_cls, 2), part(qkv, 2), thw,
                                 self.pool_v, self.norm_v)
        # the cls key and value join the pooled ones, in the reference's
        # [cls, pooled] order
        kh = self._heads(torch.cat([k_cls, k], dim=1))
        vh = self._heads(torch.cat([v_cls, v], dim=1))
        out = flash_attention.flash_attention(self._heads(q), kh, vh, scale)
        out = out.transpose(1, 2).reshape(B, -1, C)

        # the single cls query row: fp32 softmax of (q · scale) kᵀ
        qc = self._heads(q_cls) * scale
        s = torch.matmul(qc.float(), kh.float().transpose(-1, -2))
        p = torch.softmax(s, dim=-1).to(x.dtype)
        oc = torch.matmul(p.float(), vh.float()).to(x.dtype)
        out_cls = oc.transpose(1, 2).reshape(B, 1, C)
        return (linear(out_cls, self.proj), linear(out, self.proj)), q_thw


class MultiScaleBlock(nn.Module):
    """mvit.py:285-431, in split-cls layout."""

    def __init__(self, dim, dim_out, num_heads, mlp_ratio=4.0, qkv_bias=True,
                 dropout_rate=0.0, droppath_rate=0.0, kernel_q=(),
                 kernel_kv=(), stride_q=(), stride_kv=(), has_cls_embed=True,
                 mesh=None):
        super().__init__()
        self.mesh = mesh  # DropPath's data rank
        if dropout_rate or not has_cls_embed:
            raise NotImplementedError(
                "MViT blocks with dropout or without the cls token are not "
                "ported yet (MaskFeat builds neither)")
        self.dim, self.dim_out = dim, dim_out
        self.droppath_rate = float(droppath_rate)
        self.stride_q = tuple(stride_q)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = MultiScaleAttention(dim, num_heads, qkv_bias, kernel_q,
                                        kernel_kv, stride_q, stride_kv)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        hidden = int(dim * mlp_ratio)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(dim, hidden)
        self.mlp.fc2 = nn.Linear(hidden, dim_out)
        self.proj = nn.Linear(dim, dim_out) if dim != dim_out else None

    def reset_parameters(self, generator):
        for norm in (self.norm1, self.norm2):
            init.ones_(norm.weight)
            init.zeros_(norm.bias)
        self.attn.reset_parameters(generator)
        for fc in (self.mlp.fc1, self.mlp.fc2, self.proj):
            if fc is not None:
                init.trunc_normal_(fc.weight, generator, std=0.02)
                init.zeros_(fc.bias)

    def _droppath_pair(self, h, h_cls, generator):
        """Stochastic depth with ONE keep mask per sample for the patch and
        cls parts (mvit.py:325-340); uniforms from ``generator``, drawn for
        the global batch under data parallelism."""
        if not self.training or self.droppath_rate == 0.0:
            return h, h_cls
        keep = 1.0 - self.droppath_rate
        u = _mesh.rand_rows((h.shape[0], 1, 1), generator, h.dtype, h.device,
                            self.mesh)
        mask = torch.floor(keep + u)
        return h / keep * mask, h_cls / keep * mask

    def _mlp(self, t):
        return linear(F.gelu(linear(t, self.mlp.fc1)), self.mlp.fc2)

    def forward(self, x, x_cls, thw, generator=None):
        (attn_cls, attn_out), thw_new = self.attn(
            layer_norm(x, self.norm1), layer_norm(x_cls, self.norm1), thw)
        if int(np.prod(self.stride_q or (1,))) > 1:
            # skip-path pooling (pytorchvideo pool_skip), on the patch tokens
            kernel = [s + 1 if s > 1 else s for s in self.stride_q]
            B, L, C = x.shape
            x = _maxpool3d(x.reshape(B, *thw, C), kernel, self.stride_q,
                           [k // 2 for k in kernel]).reshape(B, -1, C)
        attn_out, attn_cls = self._droppath_pair(attn_out, attn_cls,
                                                 generator)
        x = x + attn_out
        x_cls = x_cls + attn_cls
        xc = layer_norm(x_cls, self.norm2)
        hc = self._mlp(xc)
        if self.proj is None:
            dt = x.dtype
            n, fc1, fc2 = self.norm2, self.mlp.fc1, self.mlp.fc2
            h = fused_ffn.fused_prenorm_ffn(
                x.contiguous(), n.weight.to(dt), n.bias.to(dt),
                fc1.weight.to(dt), fc1.bias.to(dt), fc2.weight.to(dt),
                fc2.bias.to(dt), LN_EPS)
        else:
            xn = layer_norm(x, self.norm2)
            h = self._mlp(xn)
            x, x_cls = linear(xn, self.proj), linear(xc, self.proj)
        h, hc = self._droppath_pair(h, hc, generator)
        return (x_cls + hc, x + h), thw_new


class SpatioTemporalClsPositionalEncoding(nn.Module):
    """sep_pos_embed=True (video_transformer.py:693-698): the spatial table
    tiled over T plus the temporal table repeated over H·W; the cls token
    gets its own slot."""

    def __init__(self, embed_dim, patch_embed_shape):
        super().__init__()
        T, H, W = patch_embed_shape
        self.pos_embed_spatial = nn.Parameter(torch.empty(1, H * W, embed_dim))
        self.pos_embed_temporal = nn.Parameter(torch.empty(1, T, embed_dim))
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.pos_embed_class = nn.Parameter(torch.empty(1, 1, embed_dim))

    def reset_parameters(self, generator):
        for p in (self.pos_embed_spatial, self.pos_embed_temporal,
                  self.cls_token, self.pos_embed_class):
            init.trunc_normal_(p, generator, std=0.02)

    def forward(self, x):
        """x (B, T·H·W, D) -> (cls (B, 1, D), x + pos), in x's dtype."""
        B, _, D = x.shape
        T, HW = self.pos_embed_temporal.shape[1], self.pos_embed_spatial.shape[1]
        cls = (self.cls_token + self.pos_embed_class).to(x.dtype).expand(B, 1, D)
        pos = (self.pos_embed_spatial.repeat(1, T, 1)
               + self.pos_embed_temporal.repeat_interleave(HW, dim=1))
        return cls, x + pos.to(x.dtype)


class MultiscaleVisionTransformers(nn.Module):
    """Positional encoding, the block stack and the final LayerNorm
    (mvit.py:476-504)."""

    def __init__(self, embed_dim, patch_embed_shape, block_configs,
                 mesh=None):
        super().__init__()
        self.patch_embed_shape = tuple(patch_embed_shape)
        self.cls_positional_encoding = SpatioTemporalClsPositionalEncoding(
            embed_dim, patch_embed_shape)
        self.blocks = nn.ModuleList(
            [MultiScaleBlock(**cfg, mesh=mesh) for cfg in block_configs])
        self.norm_embed = nn.LayerNorm(block_configs[-1]["dim_out"],
                                       eps=LN_EPS)

    def reset_parameters(self, generator):
        self.cls_positional_encoding.reset_parameters(generator)
        for blk in self.blocks:
            blk.reset_parameters(generator)
        init.ones_(self.norm_embed.weight)
        init.zeros_(self.norm_embed.bias)

    def forward(self, x, generator=None):
        """x (B, T·H·W, D) patch tokens -> (B, 1 + L', D') features."""
        x_cls, x = self.cls_positional_encoding(x)
        thw = self.patch_embed_shape
        for blk in self.blocks:
            (x_cls, x), thw = blk(x, x_cls, thw, generator)
        return layer_norm(torch.cat([x_cls, x], dim=1), self.norm_embed)


def build_mvit_block_configs(
    depth=16,
    num_heads=1,
    patch_embed_dim=96,
    mlp_ratio=4.0,
    qkv_bias=True,
    dropout_rate_block=0.0,
    droppath_rate_block=0.0,
    embed_dim_mul=None,
    atten_head_mul=None,
    pool_q_stride_size=None,
    pool_kv_stride_size=None,
    pool_kv_stride_adaptive=None,
    pool_kvq_kernel=None,
    has_cls=True,
):
    """The reference's block schedule (video_transformer.py:700-786), a copy
    of the JAX package's. Returns (block_configs, final_embed_dim)."""
    dpr = list(np.linspace(0, droppath_rate_block, depth))

    dim_mul = np.ones(depth + 1)
    head_mul = np.ones(depth + 1)
    if embed_dim_mul is not None:
        for i, m in embed_dim_mul:
            dim_mul[i] = m
    if atten_head_mul is not None:
        for i, m in atten_head_mul:
            head_mul[i] = m

    pool_q = [[] for _ in range(depth)]
    pool_kv = [[] for _ in range(depth)]
    stride_q = [[] for _ in range(depth)]
    stride_kv = [[] for _ in range(depth)]

    if pool_q_stride_size is not None:
        for entry in pool_q_stride_size:
            i = entry[0]
            stride_q[i] = list(entry[1:])
            if pool_kvq_kernel is not None:
                pool_q[i] = list(pool_kvq_kernel)
            else:
                pool_q[i] = [s + 1 if s > 1 else s for s in entry[1:]]

    if pool_kv_stride_adaptive is not None:
        if pool_kv_stride_size is not None:
            raise ValueError("pool_kv_stride_size and pool_kv_stride_adaptive "
                             "are exclusive")
        _stride_kv = list(pool_kv_stride_adaptive)
        pool_kv_stride_size = []
        for i in range(depth):
            if len(stride_q[i]) > 0:
                _stride_kv = [
                    max(_stride_kv[d] // stride_q[i][d], 1)
                    for d in range(len(_stride_kv))
                ]
            pool_kv_stride_size.append([i] + _stride_kv)

    if pool_kv_stride_size is not None:
        for entry in pool_kv_stride_size:
            i = entry[0]
            stride_kv[i] = list(entry[1:])
            if pool_kvq_kernel is not None:
                pool_kv[i] = list(pool_kvq_kernel)
            else:
                pool_kv[i] = [s + 1 if s > 1 else s for s in entry[1:]]

    configs = []
    heads = num_heads
    dim = patch_embed_dim
    for i in range(depth):
        heads = round_width(heads, head_mul[i], min_width=1, divisor=1)
        dim = round_width(dim, dim_mul[i], divisor=heads)
        dim_out = round_width(
            dim, dim_mul[i + 1], divisor=round_width(heads, head_mul[i + 1]))
        configs.append(dict(
            dim=dim, dim_out=dim_out, num_heads=heads, mlp_ratio=mlp_ratio,
            qkv_bias=qkv_bias, dropout_rate=dropout_rate_block,
            droppath_rate=float(dpr[i]),
            kernel_q=tuple(pool_q[i]), kernel_kv=tuple(pool_kv[i]),
            stride_q=tuple(stride_q[i]), stride_kv=tuple(stride_kv[i]),
            has_cls_embed=has_cls,
        ))
        # the running dim is re-derived from dim_mul[i] each iteration
        # (video_transformer.py:755-761): dim_{i+1} == dim_out_i
    return tuple(configs), configs[-1]["dim_out"]


def create_multiscale_vision_transformers(
    spatial_size,
    temporal_size,
    depth=16,
    patch_embed_dim=96,
    conv_patch_embed_stride=(2, 4, 4),
    num_heads=1,
    mlp_ratio=4.0,
    qkv_bias=True,
    droppath_rate_block=0.0,
    embed_dim_mul=None,
    atten_head_mul=None,
    pool_q_stride_size=None,
    pool_kv_stride_size=None,
    pool_kv_stride_adaptive=None,
    pool_kvq_kernel=None,
    mesh=None,
):
    """The MViT trunk of video_transformer.py:621-800 (mvit.py:593-638):
    positional encoding + blocks + final norm; the caller embeds patches.
    ``mesh``: a data-parallel run's (``parallel/mesh.py``), for DropPath's
    draws. Returns (module, final_embed_dim)."""
    if isinstance(spatial_size, int):
        spatial_size = (spatial_size, spatial_size)
    input_dims = [temporal_size, spatial_size[0], spatial_size[1]]
    patch_embed_shape = tuple(
        input_dims[i] // conv_patch_embed_stride[i] for i in range(3))
    block_configs, embed_dim = build_mvit_block_configs(
        depth=depth, num_heads=num_heads, patch_embed_dim=patch_embed_dim,
        mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
        droppath_rate_block=droppath_rate_block,
        embed_dim_mul=embed_dim_mul, atten_head_mul=atten_head_mul,
        pool_q_stride_size=pool_q_stride_size,
        pool_kv_stride_size=pool_kv_stride_size,
        pool_kv_stride_adaptive=pool_kv_stride_adaptive,
        pool_kvq_kernel=pool_kvq_kernel)
    return MultiscaleVisionTransformers(patch_embed_dim, patch_embed_shape,
                                        block_configs, mesh), embed_dim
