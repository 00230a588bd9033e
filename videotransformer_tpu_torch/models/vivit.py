"""ViViT: joint space-time (Model 1), factorised encoder (Model 2) and
divided space-time (Model 3) attention over tubelet tokens.

Port of ``videotransformer_tpu/models/vivit.py``. A Conv3d tubelet embedding
(``tube_size`` frames x 16 x 16) turns a clip of ``num_frames`` frames into
``num_frames // tube_size`` effective frames of p patches each; then:

- ``joint_space_time``: +cls, +pos_embed (p + 1 slots), +time_embed per
  patch (T' slots), one ``(self_attn, ffn)`` stack over the whole
  ``1 + p·T'`` sequence;
- ``divided_space_time``: the same tokens through ``(time_attn,
  space_attn, ffn)`` blocks over the effective frames;
- ``fact_encoder``: a ``num_transformer_layers`` spatial stack over each
  effective frame's ``1 + p`` tokens (+cls, +pos_embed), then a
  ``num_time_transformer_layers`` temporal stack over ``1 + T'`` tokens: the
  cls row and the frames' mean-pooled patch tokens, +time_embed (T' + 1
  slots). The cls row fed to the temporal stack is ``x[:b, 0]`` of the
  ``(b·T', 1 + p, d)`` spatial output, the original repo's quirk
  (video_transformer.py:515): for b > 1 those rows are sample 0's first b
  frames, and the JAX package keeps it, since published checkpoints depend
  on it. So does the port, for the global batch under data parallelism:
  the rows come from the data ranks that hold them (``mesh.gather_data``),
  as the JAX trainer's global array gives them.

Then the final LayerNorm (eps 1e-6) and the cls row, or the mean of the
other rows when ``return_cls_token`` is False. ``remat`` checkpoints every
block of every stack while autograd records; ``return_attention`` and
``get_last_selfattention`` return the last block's last attention weights
of the (temporal, for fact_encoder) stack (vivit.py:202-234;
``ops/blocks.py``). The two fact_encoder stacks
are ``transformer_layers.0`` and ``.1``, the original repo's names, so a
converted state dict loads with ``strict=True``. Position tables are
learnable, as the JAX trainer builds them. ``model.train()`` turns on
DropPath and the dropouts as in ``models/timesformer.py``; the working
type is the clip's dtype. ``mesh`` (a parallel run's, ``parallel/mesh.py``)
goes to the blocks: with ``model`` > 1 ranks they hold this rank's shard
(``ops/blocks.py``, ``parallel/tp.py``). With ``seq`` > 1 ranks
(``parallel/sp.py``) joint and divided attention embed this rank's p / sp
patches in every effective frame; fact_encoder's spatial stack runs this
rank's T' / sp effective frames, whose cls rows and patch means are
gathered over the seq group (``mesh.gather_seq``) for the temporal stack,
which every seq rank runs whole.
"""

import torch
import torch.nn.functional as F
from torch import nn

from videotransformer_tpu_torch.ops import initializers as init
from videotransformer_tpu_torch.ops.blocks import (
    PatchEmbed, TransformerContainer, last_selfattention)
from videotransformer_tpu_torch.parallel import mesh as _mesh
from videotransformer_tpu_torch.parallel import sp as _sp
from videotransformer_tpu_torch.utils import profiling

FINAL_LN_EPS = 1e-6
ATTENTION_TYPES = ("fact_encoder", "joint_space_time", "divided_space_time")


class ViViT(nn.Module):

    def __init__(self, num_frames, img_size=224, patch_size=16, embed_dims=768,
                 num_heads=12, num_transformer_layers=12, in_channels=3,
                 dropout_p=0.0, tube_size=2, attention_type="fact_encoder",
                 return_cls_token=True, num_time_transformer_layers=4,
                 drop_path_rate=0.1, mesh=None, remat=False):
        super().__init__()
        self.mesh = mesh
        if attention_type not in ATTENTION_TYPES:
            raise ValueError(f"Unsupported Attention Type {attention_type}!")
        self.attention_type = attention_type
        self.return_cls_token = return_cls_token
        self.eff_frames = num_frames // tube_size
        self.patch_embed = PatchEmbed(img_size, patch_size, in_channels,
                                      embed_dims, tube_size, "Conv3d")
        num_patches = self.patch_embed.num_patches
        if attention_type != "fact_encoder":
            _sp.check_divides("patches", num_patches, mesh)
        if attention_type != "joint_space_time":
            _sp.check_divides("effective frames", self.eff_frames, mesh)
        stack = lambda depth, order, layout="tokens": TransformerContainer(
            depth, embed_dims, num_heads, self.eff_frames, 4 * embed_dims,
            order, drop_path_rate, mesh, remat, layout)
        if attention_type == "fact_encoder":
            self.transformer_layers = nn.ModuleList([
                stack(num_transformer_layers, ("self_attn", "ffn"), "frames"),
                stack(num_time_transformer_layers, ("self_attn", "ffn"),
                      "replicated")])
        elif attention_type == "joint_space_time":
            self.transformer_layers = stack(num_transformer_layers,
                                            ("self_attn", "ffn"))
        else:
            self.transformer_layers = stack(
                num_transformer_layers, ("time_attn", "space_attn", "ffn"))
        self.norm = nn.LayerNorm(embed_dims, eps=FINAL_LN_EPS)
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dims))
        # operator_order[-2] is never 'time_attn' here, so the cls slot is in
        # the spatial table (vivit.py:155-164); fact_encoder's temporal
        # table has one for the cls row too
        n_frames = self.eff_frames + (attention_type == "fact_encoder")
        self.pos_embed = nn.Parameter(
            torch.empty(1, num_patches + 1, embed_dims))
        self.time_embed = nn.Parameter(torch.empty(1, n_frames, embed_dims))
        self.pos_drop = nn.Dropout(dropout_p)
        self.time_drop = nn.Dropout(dropout_p)

    def reset_parameters(self, generator):
        """The JAX package's initialisation, drawn from ``generator``."""
        self.patch_embed.reset_parameters(generator)
        for m in (self.transformer_layers if self.attention_type
                  == "fact_encoder" else [self.transformer_layers]):
            m.reset_parameters(generator)
        init.ones_(self.norm.weight)
        init.zeros_(self.norm.bias)
        for p in (self.cls_token, self.pos_embed, self.time_embed):
            init.trunc_normal_(p, generator, std=0.02)

    def prepare_tokens(self, x):
        """(b, t, c, h, w) -> (b·T', 1 + p, d) for fact_encoder, else
        (b, 1 + p·T', d) (vivit.py:178-212); under sequence parallelism
        this rank's T' / sp frames, or p / sp patches."""
        b, t = x.shape[:2]
        dt = x.dtype
        keep, pos = None, self.pos_embed.to(dt)
        if self.attention_type == "fact_encoder":
            x = x[:, _sp.shard(t, self.mesh)]  # whole tubes: sp divides T'
        elif _mesh.seq_ranks(self.mesh) > 1:
            keep = _sp.shard(self.patch_embed.num_patches, self.mesh)
            pos = torch.cat([pos[:, :1], pos[:, 1:][:, keep]], dim=1)
        x = self.patch_embed(x, keep)  # (b T', p, d)
        bt, p, d = x.shape
        x = torch.cat([self.cls_token.to(dt).expand(bt, 1, d), x], dim=1)
        x = self.pos_drop(x + pos)
        if self.attention_type == "fact_encoder":
            return x
        t = self.eff_frames
        cls_tokens = x[:b, :1]  # every cls row is the same here
        patches = x[:, 1:].reshape(b, t, p, d).transpose(1, 2)
        patches = patches.reshape(b * p, t, d) + self.time_embed.to(dt)
        x = torch.cat([cls_tokens, patches.reshape(b, p * t, d)], dim=1)
        return self.time_drop(x)

    def forward(self, x, generator=None, return_attention=False):
        """(b, t, c, h, w) clip in the working type -> (b, d) features;
        ``generator`` feeds DropPath in training mode. With
        ``return_attention``: the last attention weights (fp32), of the
        temporal stack for fact_encoder. While a profiler session is
        active ``prepare_tokens`` records the span ``vivit.embed``
        (``utils/profiling.py``), with its device time on a card."""
        b = x.shape[0]
        with profiling.span("vivit.embed", device=x.device):
            x = self.prepare_tokens(x)
        if self.attention_type != "fact_encoder":
            x = self.transformer_layers(x, generator, return_attention)
        else:
            spatial, temporal = self.transformer_layers
            x = spatial(x, generator)
            bt, p1, d = x.shape
            # every effective frame's rows, from the seq ranks holding them
            cls_rows = _mesh.gather_seq(x[:, 0].reshape(b, bt // b, d),
                                        self.mesh, 1).reshape(-1, d)
            # the x[:b, 0] quirk (module doc), rows of the global batch
            r = 0 if self.mesh is None else self.mesh.data_rank
            cls_tokens = _mesh.gather_data(cls_rows, self.mesh)[
                r * b:(r + 1) * b, None]
            patches = _mesh.gather_seq(
                x[:, 1:].reshape(b, bt // b, p1 - 1, d).mean(dim=2),
                self.mesh, 1)
            x = torch.cat([cls_tokens, patches], dim=1)
            x = self.time_drop(x + self.time_embed.to(x.dtype))
            x = temporal(x, generator, return_attention)
        if return_attention:
            return x
        return self.finish(x, b)

    def finish(self, x, clips):
        """The last stack's output ``x`` of a batch of ``clips`` clips ->
        (clips, d) features: the final LayerNorm, then the cls row or the
        mean of the other rows (the pipeline's last stage runs it too,
        ``parallel/pp.py``)."""
        # final LayerNorm outside the kernels: fp32 statistics, working type
        x = F.layer_norm(x.float(), x.shape[-1:], self.norm.weight.float(),
                         self.norm.bias.float(), FINAL_LN_EPS).to(x.dtype)
        if self.return_cls_token:
            return x[:, 0]
        return x[:, 1:].mean(dim=1)

    def get_last_selfattention(self, x):
        """vivit.py:233-234: the weights in eval mode."""
        return last_selfattention(self, x)

