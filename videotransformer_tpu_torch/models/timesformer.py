"""TimeSformer: divided space-time, joint space-time and space-only
attention.

Port of ``videotransformer_tpu/models/timesformer.py``: patch embed -> +cls
-> +pos_embed -> fold to ``(b p) t d`` -> +time_embed -> flat patch-major
``b (p t) d`` sequence -> blocks -> final LayerNorm (eps 1e-6) -> cls
readout, with learnable position tables (TimeSformer-B's setting). The cls
token takes the spatial ``pos_embed`` and skips ``time_embed``
(timesformer.py:118-124, 177-184). The blocks are ``(time_attn,
space_attn, ffn)`` for ``divided_space_time`` and ``(self_attn, ffn)``
otherwise. ``joint_space_time`` attends over the whole ``1 + p·t``
sequence; ``space_only`` has no ``time_embed``, runs the blocks on each
frame's ``1 + p`` tokens and averages the frames after them
(timesformer.py:196-199).

``model.train()`` is the JAX package's ``deterministic=False``: DropPath
(``drop_path_rate``, 0.1 by default, timesformer.py:79) and the
``pos_drop``/``time_drop`` dropouts (``dropout_p``, 0 by default) act, with
DropPath drawing from the ``generator`` given to ``forward``; the dropouts
use torch's default generator, and at p = 0 draw nothing. The working type
is the clip's dtype: fp32 parameters are cast to it at each use.

``remat`` checkpoints each block while autograd records, and
``return_attention`` / ``get_last_selfattention`` return the last block's
last attention weights (timesformer.py:189-207; ``ops/blocks.py``).

At another resolution than the native one the spatial table is resized by
``interpolate_pos_encoding``, as in the JAX package. ``mesh`` (a parallel
run's, ``parallel/mesh.py``) goes to the blocks: with ``model`` > 1 ranks
they hold this rank's shard (``ops/blocks.py``, ``parallel/tp.py``). With
``seq`` > 1 ranks (``parallel/sp.py``) the model embeds this rank's
patches only, the cls row and the tokens of p / sp patches in every frame
(divided and joint attention), or this rank's frames (space_only, whose
frame mean then sums over the seq group); the cls readout is the same on
every seq rank.
"""

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from videotransformer_tpu_torch.ops import initializers as init
from videotransformer_tpu_torch.ops.blocks import (
    PatchEmbed, TransformerContainer, last_selfattention)
from videotransformer_tpu_torch.parallel import mesh as _mesh
from videotransformer_tpu_torch.parallel import sp as _sp

FINAL_LN_EPS = 1e-6
ATTENTION_TYPES = ("divided_space_time", "space_only", "joint_space_time")


def _keys_cubic(x):
    """Keys' cubic kernel with a = -0.5 (jax/_src/image/scale.py)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


@functools.lru_cache(maxsize=None)
def resize_weights(n_in, n_out):
    """The (n_in, n_out) float32 matrix of ``jax.image.resize(...,
    "bicubic")`` along one axis: Keys' cubic with a = -0.5 at the
    half-pixel sample points, widened by the scale when it shrinks
    (antialiasing), each column divided by its sum (the edges renormalised,
    not clamped), columns whose sample point lies outside the input zero.
    ``compute_weight_mat`` of jax/_src/image/scale.py, in its float32
    arithmetic. Not ``F.interpolate``'s bicubic (a = -0.75, clamped
    edges, no antialiasing)."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out, dtype=np.float32) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]
               ) / kernel_scale
    w = _keys_cubic(x).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def _resize_weights_on(n_in, n_out, device, dtype):
    """``resize_weights`` on ``device`` in ``dtype``: copied up once
    (``_resize_weights_cached``), but made anew under ``torch.export``,
    where it is a constant of the program and the cast and copy are its
    ops (a cached tensor would be the trace's fake one)."""
    if torch.compiler.is_compiling():
        return torch.from_numpy(resize_weights(n_in, n_out)).to(
            device=device, dtype=dtype)
    return _resize_weights_cached(n_in, n_out, device, dtype)


@functools.lru_cache(maxsize=None)
def _resize_weights_cached(n_in, n_out, device, dtype):
    """``resize_weights`` on ``device`` in ``dtype``, copied up once: from
    pinned memory without blocking on a card, so a forward never waits on
    the host."""
    w = torch.from_numpy(resize_weights(n_in, n_out)).to(dtype)
    if device.type == "cuda":
        return w.pin_memory().to(device, non_blocking=True)
    return w.to(device)


def interpolate_pos_encoding(pos_embed, npatch, w, h, patch_size):
    """``pos_embed`` (1, N + 1, D), the cls slot first, for an input of
    ``npatch`` patches of a w x h frame (timesformer.py:43-63): the
    identity when ``npatch == N`` and w == h, else the patch table as a
    side x side grid resized to (w0, h0) = (w, h) // patch_size, in the JAX
    package's order (w0 first), as ``jax.image.resize(..., "bicubic")``
    does: one product with each axis's ``resize_weights`` (an axis whose
    size does not change is left as it is), in the table's dtype."""
    n = pos_embed.shape[1] - 1
    if npatch == n and w == h:
        return pos_embed
    dim = pos_embed.shape[-1]
    w0, h0 = w // patch_size, h // patch_size
    side = int(math.sqrt(n))
    grid = pos_embed[0, 1:].reshape(side, side, dim)
    on = lambda n_out: _resize_weights_on(side, n_out, pos_embed.device,
                                          pos_embed.dtype)
    if w0 != side:  # (w0, side) @ (side, side·dim)
        grid = (on(w0).t() @ grid.reshape(side, side * dim)).reshape(
            w0, side, dim)
    if h0 != side:  # (h0, side) @ (w0, side, dim) -> (w0, h0, dim)
        grid = on(h0).t() @ grid
    return torch.cat([pos_embed[:, :1], grid.reshape(1, w0 * h0, dim)],
                     dim=1)


class TimeSformer(nn.Module):

    def __init__(self, num_frames, img_size=224, patch_size=16, embed_dims=768,
                 num_heads=12, num_transformer_layers=12, in_channels=3,
                 attention_type="divided_space_time", drop_path_rate=0.1,
                 dropout_p=0.0, mesh=None, remat=False):
        super().__init__()
        if attention_type not in ATTENTION_TYPES:
            raise ValueError(f"Unsupported Attention Type {attention_type}!")
        self.attention_type = attention_type
        self.num_frames = num_frames
        self.patch_size = patch_size
        self.mesh = mesh
        self.patch_embed = PatchEmbed(img_size, patch_size, in_channels,
                                      embed_dims)
        num_patches = self.patch_embed.num_patches
        if attention_type != "space_only":
            _sp.check_divides("patches", num_patches, mesh)
        if attention_type != "joint_space_time":
            _sp.check_divides("frames", num_frames, mesh)
        self.transformer_layers = TransformerContainer(
            num_transformer_layers, embed_dims, num_heads, num_frames,
            hidden_channels=4 * embed_dims,
            operator_order=(("time_attn", "space_attn", "ffn")
                            if attention_type == "divided_space_time"
                            else ("self_attn", "ffn")),
            drop_path_rate=drop_path_rate, mesh=mesh, remat=remat,
            seq_layout=("frames" if attention_type == "space_only"
                        else "tokens"))
        self.norm = nn.LayerNorm(embed_dims, eps=FINAL_LN_EPS)
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dims))
        # operator_order[-2] is 'space_attn' or 'self_attn': the cls slot is
        # in the spatial table only (timesformer.py:118-124)
        self.pos_embed = nn.Parameter(
            torch.empty(1, num_patches + 1, embed_dims))
        if attention_type != "space_only":
            self.time_embed = nn.Parameter(
                torch.empty(1, num_frames, embed_dims))
        self.pos_drop = nn.Dropout(dropout_p)
        self.time_drop = nn.Dropout(dropout_p)

    def reset_parameters(self, generator):
        """The JAX package's initialisation, drawn from ``generator``."""
        self.patch_embed.reset_parameters(generator)
        self.transformer_layers.reset_parameters(generator)
        init.ones_(self.norm.weight)
        init.zeros_(self.norm.bias)
        for p in (self.cls_token, self.pos_embed,
                  getattr(self, "time_embed", None)):
            if p is not None:
                init.trunc_normal_(p, generator, std=0.02)

    def prepare_tokens(self, x):
        """(b, t, c, h, w) -> (b, 1 + p·t, d), or (b·t, 1 + p, d) for
        space_only (timesformer.py:142-187); under sequence parallelism
        this rank's p / sp patches, or t / sp frames."""
        b, t, c, h, w = x.shape
        dt = x.dtype
        npatch = (h // self.patch_size) * (w // self.patch_size)
        keep = None
        if self.attention_type == "space_only":
            x = x[:, _sp.shard(t, self.mesh)]
            t = x.shape[1]
        elif _mesh.seq_ranks(self.mesh) > 1:
            keep = _sp.shard(npatch, self.mesh)
        x = self.patch_embed(x, keep)  # (b t, p, d)
        bt, p, d = x.shape
        cls_tok = self.cls_token.to(dt).expand(bt, 1, d)
        x = torch.cat([cls_tok, x], dim=1)
        pos = interpolate_pos_encoding(self.pos_embed.to(dt), npatch, w, h,
                                       self.patch_size)
        if keep is not None:
            pos = torch.cat([pos[:, :1], pos[:, 1:][:, keep]], dim=1)
        x = self.pos_drop(x + pos)
        if self.attention_type == "space_only":
            return x
        cls_tokens = x[:b, :1]  # every cls row is the same here
        patches = x[:, 1:].reshape(b, t, p, d).transpose(1, 2)
        patches = patches.reshape(b * p, t, d) + self.time_embed.to(dt)
        x = torch.cat([cls_tokens, patches.reshape(b, p * t, d)], dim=1)
        return self.time_drop(x)

    def forward(self, x, generator=None, return_attention=False):
        """(b, t, c, h, w) clip in the working type -> (b, d) features;
        ``generator`` feeds DropPath in training mode. With
        ``return_attention``: the last block's last attention weights, fp32
        (b·t, H, 1 + p, 1 + p) for divided and space-only attention, (b, H,
        N, N) for joint."""
        b = x.shape[0]
        x = self.transformer_layers(self.prepare_tokens(x), generator,
                                    return_attention)
        if return_attention:
            return x
        return self.finish(x, b)

    def finish(self, x, clips):
        """The blocks' output ``x`` of a batch of ``clips`` clips -> (clips,
        d) features: space_only's mean over a clip's frames, the final
        LayerNorm, the cls row (the pipeline's last stage runs it too,
        ``parallel/pp.py``)."""
        if self.attention_type == "space_only":  # the mean over frames
            x = _sp.seq_mean(x.reshape(clips, -1, *x.shape[1:]),
                             self.mesh)[:, 0]
        # final LayerNorm outside the kernels: fp32 statistics, working type
        x = F.layer_norm(x.float(), x.shape[-1:], self.norm.weight.float(),
                         self.norm.bias.float(), FINAL_LN_EPS).to(x.dtype)
        return x[:, 0]

    def get_last_selfattention(self, x):
        """timesformer.py:205-206: the weights in eval mode."""
        return last_selfattention(self, x)


def get_vit_base_patch16_224(num_frames, img_size=224,
                             attention_type="divided_space_time",
                             drop_path_rate=0.1, remat=False):
    """TimeSformer-B/16 (timesformer.py:210-226)."""
    return TimeSformer(num_frames=num_frames, img_size=img_size,
                       patch_size=16, embed_dims=768, num_heads=12,
                       num_transformer_layers=12, in_channels=3,
                       attention_type=attention_type,
                       drop_path_rate=drop_path_rate, remat=remat)
