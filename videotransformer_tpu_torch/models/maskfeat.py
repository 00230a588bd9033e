"""MaskFeat: masked HOG-feature prediction on an MViT trunk.

Port of ``videotransformer_tpu/models/maskfeat.py`` (the original repo's
video_transformer.py:803-922):

- a Conv3d patch embed, kernel (3, 7, 7), stride (2, 4, 4), padding
  (1, 3, 3), xavier-uniform on the flattened kernel;
- mask-token substitution after the patch embed: the (T', h, w) cube mask,
  upsampled nearest by ``downsample_rate``, mixes ``x·(1 - w) + token·w``;
- the MViT trunk (``models.mvit``), then ``decoder_pred`` (embed -> 216);
- the predictions reshaped ``b (t h w) (dt dc) -> b (t dt) h w dc`` and the
  MSE on the masked positions of the cube-center frames only, with the
  ragged cube markers padded to (B, M, 2) plus a count (maskfeat.py:130-151).

``forward_features`` is also the supervised MViT backbone (the trainer takes
``forward_features(x)[:, 0]``). The working type is the clip's dtype; the
loss is fp32.
"""

import torch
import torch.nn.functional as F
from torch import nn

from videotransformer_tpu_torch.models.mvit import (
    create_multiscale_vision_transformers, linear)
from videotransformer_tpu_torch.ops import initializers as init
from videotransformer_tpu_torch.parallel import mesh as _mesh


class _PatchEmbed(nn.Module):
    """pytorchvideo's PatchEmbed: a Conv3d under ``patch_model``."""

    def __init__(self, in_channels, out_channels, kernel, stride, padding):
        super().__init__()
        self.patch_model = nn.Conv3d(in_channels, out_channels, kernel,
                                     stride, padding)

    def forward(self, x):
        """(B, T, C, H, W) -> (B, T'·H'·W', D)."""
        conv = self.patch_model
        y = F.conv3d(x.permute(0, 2, 1, 3, 4), conv.weight.to(x.dtype),
                     conv.bias.to(x.dtype), conv.stride, conv.padding)
        return y.flatten(2).transpose(1, 2)


class MaskFeat(nn.Module):

    def __init__(self, img_size=224, num_frames=16, input_channels=3,
                 feature_dim=2 * 2 * 2 * 3 * 9, patch_embed_dim=96,
                 conv_patch_embed_kernel=(3, 7, 7),
                 conv_patch_embed_stride=(2, 4, 4),
                 conv_patch_embed_padding=(1, 3, 3),
                 embed_dim_mul=((1, 2.0), (3, 2.0), (14, 2.0)),
                 atten_head_mul=((1, 2.0), (3, 2.0), (14, 2.0)),
                 pool_q_stride_size=((1, 1, 2, 2), (3, 1, 2, 2),
                                     (14, 1, 2, 2)),
                 pool_kv_stride_adaptive=(1, 8, 8),
                 pool_kvq_kernel=(3, 3, 3), depth=16, mesh=None):
        super().__init__()
        self.mesh = mesh  # a data-parallel run's: the loss's global count
        self.img_size = img_size
        self.num_frames = num_frames
        self.feature_dim = feature_dim
        self.stride = tuple(conv_patch_embed_stride)
        self.downsample_rate = 2 ** len(pool_q_stride_size)
        self.patch_embed = _PatchEmbed(input_channels, patch_embed_dim,
                                       conv_patch_embed_kernel, self.stride,
                                       conv_patch_embed_padding)
        self.mvit, self.embed_dims = create_multiscale_vision_transformers(
            spatial_size=img_size, temporal_size=num_frames,
            embed_dim_mul=[list(x) for x in embed_dim_mul],
            atten_head_mul=[list(x) for x in atten_head_mul],
            pool_q_stride_size=[list(x) for x in pool_q_stride_size],
            pool_kv_stride_adaptive=list(pool_kv_stride_adaptive),
            pool_kvq_kernel=list(pool_kvq_kernel), depth=depth,
            patch_embed_dim=patch_embed_dim,
            conv_patch_embed_stride=self.stride, mesh=mesh)
        self.decoder_pred = nn.Linear(self.embed_dims, feature_dim)
        self.mask_token = nn.Parameter(torch.empty(1, 1, patch_embed_dim))

    def reset_parameters(self, generator):
        """The JAX package's initialisation, drawn from ``generator``."""
        for layer in (self.patch_embed.patch_model, self.decoder_pred):
            init.xavier_uniform_flat_(layer.weight, generator)
            init.zeros_(layer.bias)
        self.mvit.reset_parameters(generator)
        init.trunc_normal_(self.mask_token, generator, std=0.02)

    def forward_features(self, x, mask=None, generator=None):
        """x (B, T, C, H, W) in the working type; mask (B, T', h, w) or None
        -> (B, 1 + L', embed_dims); ``generator`` feeds DropPath."""
        x = self.patch_embed(x)
        if mask is not None:
            dr = self.downsample_rate
            dense = mask.repeat_interleave(dr, 2).repeat_interleave(dr, 3)
            w = dense.reshape(x.shape[0], -1, 1).to(x.dtype)
            x = x * (1 - w) + self.mask_token.to(x.dtype) * w
        return self.mvit(x, generator)

    def forward(self, x, target_x=None, mask=None, cube_marker=None,
                cube_count=None, generator=None, visualize=False):
        """Pretraining forward (maskfeat.py:108-161): the predictions
        (B, T, h, w, dc), and with ``target_x`` (B, T, h, w, dc) also the
        masked loss; cube_marker (B, M, 2) int [start, span], padded, with
        cube_count (B,) real rows. ``visualize`` adds the center-frame mask
        and the HOG maps (B, T, 2h, 2w, 3, 9)."""
        feats = self.forward_features(x, mask, generator)
        preds = linear(feats, self.decoder_pred)[:, 1:]
        t_out = self.num_frames // self.stride[0]
        h_out = self.img_size // (self.stride[1] * self.downsample_rate)
        w_out = self.img_size // (self.stride[2] * self.downsample_rate)
        dt = self.stride[0]
        dc = self.feature_dim // dt
        # b (t h w) (dt dc) -> b (t dt) h w dc
        preds = preds.reshape(-1, t_out, h_out, w_out, dt, dc)
        preds = preds.permute(0, 1, 4, 2, 3, 5).reshape(
            -1, t_out * dt, h_out, w_out, dc)
        if target_x is None:
            return preds

        T = t_out * dt
        mask16 = mask.repeat_interleave(dt, 1).float()  # (B, T, h, w)
        if cube_marker is not None:
            # only the center frame 2·start + span of each cube keeps its mask
            centers = cube_marker[..., 0] * dt + cube_marker[..., 1] * dt // 2
            m_idx = torch.arange(cube_marker.shape[1], device=preds.device)
            valid = (m_idx[None] < cube_count[:, None]).float()
            frames = torch.arange(T, device=preds.device)
            onehot = (centers[..., None] == frames).float() * valid[..., None]
            mask16 = mask16 * onehot.sum(1).clamp(0, 1)[:, :, None, None]
        loss = ((preds.float() - target_x.float()) ** 2).mean(-1)
        # over the global batch's mask count under data parallelism
        # (maskfeat.py:151): each data rank's loss is its share of the sum
        count = _mesh.sum_over_data(mask16.sum(), self.mesh)
        loss = (loss * mask16).sum() / (count + 1e-5)
        if visualize:
            b = preds.shape[0]
            hp = preds.reshape(b, T, h_out, w_out, 2, 2, 3, 9)
            hog_preds = hp.permute(0, 1, 2, 4, 3, 5, 6, 7).reshape(
                b, T, h_out * 2, w_out * 2, 3, 9)
            return preds, loss, mask16, hog_preds
        return preds, loss
