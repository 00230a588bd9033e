"""TimeSformer with divided space-time attention.

Port of ``videotransformer_tpu/models/timesformer.py``: patch embed -> +cls
-> +pos_embed -> fold to ``(b p) t d`` -> +time_embed -> flat patch-major
``b (p t) d`` sequence -> blocks -> final LayerNorm (eps 1e-6) -> cls
readout, with learnable position tables (TimeSformer-B's setting). The cls
token takes the spatial ``pos_embed`` and skips ``time_embed``
(timesformer.py:118-124, 177-184).

``model.train()`` is the JAX package's ``deterministic=False``: DropPath
(``drop_path_rate``, 0.1 by default, timesformer.py:79) and the
``pos_drop``/``time_drop`` dropouts (``dropout_p``, 0 by default) act, with
DropPath drawing from the ``generator`` given to ``forward``; the dropouts
use torch's default generator, and at p = 0 draw nothing. The working type
is the clip's dtype: fp32 parameters are cast to it at each use.

Not ported yet (they raise): the ``space_only`` and ``joint_space_time``
attention types, and ``interpolate_pos_encoding`` at any size other than the
native one.
"""

import torch
import torch.nn.functional as F
from torch import nn

from videotransformer_tpu_torch.ops import initializers as init
from videotransformer_tpu_torch.ops.blocks import (
    PatchEmbed, TransformerContainer)

FINAL_LN_EPS = 1e-6


def interpolate_pos_encoding(pos_embed, npatch, w, h, patch_size):
    """The identity at the native size; other sizes are not ported yet."""
    if npatch == pos_embed.shape[1] - 1 and w == h:
        return pos_embed
    raise NotImplementedError(
        "interpolate_pos_encoding: only the native resolution is ported")


class TimeSformer(nn.Module):

    def __init__(self, num_frames, img_size=224, patch_size=16, embed_dims=768,
                 num_heads=12, num_transformer_layers=12, in_channels=3,
                 attention_type="divided_space_time", drop_path_rate=0.1,
                 dropout_p=0.0):
        super().__init__()
        if attention_type != "divided_space_time":
            raise NotImplementedError(
                f"attention type {attention_type!r} is not ported yet")
        self.num_frames = num_frames
        self.patch_size = patch_size
        self.patch_embed = PatchEmbed(img_size, patch_size, in_channels,
                                      embed_dims)
        num_patches = self.patch_embed.num_patches
        self.transformer_layers = TransformerContainer(
            num_transformer_layers, embed_dims, num_heads, num_frames,
            hidden_channels=4 * embed_dims,
            operator_order=("time_attn", "space_attn", "ffn"),
            drop_path_rate=drop_path_rate)
        self.norm = nn.LayerNorm(embed_dims, eps=FINAL_LN_EPS)
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dims))
        # operator_order[-2] is 'space_attn': the cls slot is in the spatial
        # table only (timesformer.py:118-124)
        self.pos_embed = nn.Parameter(
            torch.empty(1, num_patches + 1, embed_dims))
        self.time_embed = nn.Parameter(torch.empty(1, num_frames, embed_dims))
        self.pos_drop = nn.Dropout(dropout_p)
        self.time_drop = nn.Dropout(dropout_p)

    def reset_parameters(self, generator):
        """The JAX package's initialisation, drawn from ``generator``."""
        self.patch_embed.reset_parameters(generator)
        self.transformer_layers.reset_parameters(generator)
        init.ones_(self.norm.weight)
        init.zeros_(self.norm.bias)
        for p in (self.cls_token, self.pos_embed, self.time_embed):
            init.trunc_normal_(p, generator, std=0.02)

    def prepare_tokens(self, x):
        """(b, t, c, h, w) -> (b, 1 + p·t, d) (timesformer.py:142-187)."""
        b, t, c, h, w = x.shape
        dt = x.dtype
        x = self.patch_embed(x)  # (b t, p, d)
        bt, p, d = x.shape
        cls_tok = self.cls_token.to(dt).expand(bt, 1, d)
        x = torch.cat([cls_tok, x], dim=1)
        x = x + interpolate_pos_encoding(self.pos_embed.to(dt), p, w, h,
                                         self.patch_size)
        x = self.pos_drop(x)
        cls_tokens = x[:b, :1]  # every cls row is the same here
        patches = x[:, 1:].reshape(b, t, p, d).transpose(1, 2)
        patches = patches.reshape(b * p, t, d) + self.time_embed.to(dt)
        x = torch.cat([cls_tokens, patches.reshape(b, p * t, d)], dim=1)
        return self.time_drop(x)

    def forward(self, x, generator=None):
        """(b, t, c, h, w) clip in the working type -> (b, d) features;
        ``generator`` feeds DropPath in training mode."""
        x = self.transformer_layers(self.prepare_tokens(x), generator)
        # final LayerNorm outside the kernels: fp32 statistics, working type
        x = F.layer_norm(x.float(), x.shape[-1:], self.norm.weight.float(),
                         self.norm.bias.float(), FINAL_LN_EPS).to(x.dtype)
        return x[:, 0]


def get_vit_base_patch16_224(num_frames, img_size=224,
                             attention_type="divided_space_time",
                             drop_path_rate=0.1):
    """TimeSformer-B/16 (timesformer.py:210-226)."""
    return TimeSformer(num_frames=num_frames, img_size=img_size,
                       patch_size=16, embed_dims=768, num_heads=12,
                       num_transformer_layers=12, in_channels=3,
                       attention_type=attention_type,
                       drop_path_rate=drop_path_rate)
