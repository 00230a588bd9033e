"""Batched, bucketed predictor over a JAX serving artifact.

Port of ``videotransformer_tpu/serving/export.py``: ``make_predict_fn``'s
crop mean (per-crop logits averaged over the ThreeCrop stack, the notebook's
``output.view(-1, 3, 400).mean(1)``), and a ``TorchPredictor`` with
``ExportedPredictor``'s interface: ``buckets``, ``max_batch``, padding on
the host to the next bucket, ``warmup``, ``n_crops``, ``manifest``.

``load_predictor`` reads the ``params.npz`` and ``manifest.json`` that
``videotransformer_tpu.serving.export.export_predictor`` writes and ignores
its ``.shlo`` programs. Clips mode only: raw-uint8 mode needs the device
preprocessing, which is not ported yet.
"""

import json
import os

import numpy as np
import torch

from videotransformer_tpu_torch.models.convert import split_artifact_params
from videotransformer_tpu_torch.models.timesformer import TimeSformer
from videotransformer_tpu_torch.ops.blocks import ClassificationHead


def make_predict_fn(model, head, num_class, n_crops):
    """clips (B, n_crops, T, C, H, W) -> (B, num_class) crop-averaged fp32
    logits. The backbone runs in the model's working type; the head runs in
    fp32 on the features, as the JAX package's fp32 head does."""

    def predict(clips):
        b, nc, t, c, h, w = clips.shape
        feats = model(clips.reshape(b * nc, t, c, h, w))
        logits = head(feats.float())
        return logits.reshape(b, nc, num_class).mean(dim=1)

    return predict


class TorchPredictor:
    """Callable (B, n_crops, T, C, S, S) float32 numpy -> (B, num_class)
    numpy logits. Pads the batch on the host to the next bucket, runs it on
    ``device``, unpads; batches above the largest bucket run in chunks."""

    def __init__(self, model, head, manifest, device, dtype=torch.bfloat16):
        if manifest.get("input_mode", "clips") != "clips":
            raise NotImplementedError(
                "raw-uint8 input mode needs the device preprocessing port")
        self.manifest = manifest
        self.buckets = sorted(int(b) for b in manifest["buckets"])
        self.num_class = manifest["num_class"]
        self.n_crops = manifest["n_crops"]
        self.input_mode = "clips"
        self.input_dtype = np.dtype(np.float32)
        self.input_shape = (self.n_crops, manifest["num_frames"], 3,
                            manifest["img_size"], manifest["img_size"])
        self.device = torch.device(device)
        self.dtype = dtype
        # weights cast once here to the working type; the head stays fp32
        self.model = model.to(device=self.device, dtype=dtype).eval()
        self.head = head.to(device=self.device, dtype=torch.float32).eval()
        self._predict = make_predict_fn(self.model, self.head,
                                        self.num_class, self.n_crops)

    @property
    def max_batch(self):
        return self.buckets[-1]

    def _bucket(self, n):
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    @torch.inference_mode()
    def __call__(self, clips):
        clips = np.asarray(clips, self.input_dtype)
        n = clips.shape[0]
        out = []
        i = 0
        while i < n:
            take = min(n - i, self.max_batch)
            b = self._bucket(take)
            chunk = clips[i:i + take]
            if take < b:
                chunk = np.concatenate(
                    [chunk, np.zeros((b - take,) + chunk.shape[1:],
                                     chunk.dtype)], axis=0)
            x = torch.from_numpy(chunk).to(self.device).to(self.dtype)
            logits = self._predict(x)
            out.append(logits[:take].float().cpu().numpy())
            i += take
        return np.concatenate(out, axis=0)

    def warmup(self):
        """Run every bucket once, through ``__call__`` (builds the kernels
        and warms the allocator before the first request)."""
        for b in self.buckets:
            self(np.zeros((b,) + self.input_shape, self.input_dtype))


def timesformer_from_state_dict(state_dict, num_frames, img_size, num_heads):
    """A divided space-time TimeSformer shaped by a converted state dict.
    The head count is not recorded in the weights, so it is an argument."""
    embed_dims = state_dict["cls_token"].shape[-1]
    patch_size = state_dict["patch_embed.projection.weight"].shape[-1]
    depth = len({k.split(".")[2] for k in state_dict
                 if k.startswith("transformer_layers.layers.")})
    model = TimeSformer(num_frames=num_frames, img_size=img_size,
                        patch_size=patch_size, embed_dims=embed_dims,
                        num_heads=num_heads, num_transformer_layers=depth)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in state_dict.items()}, strict=True)
    return model


def load_predictor(path, device, num_heads=None, dtype=torch.bfloat16):
    """TorchPredictor over a JAX serving artifact directory. ``num_heads``
    defaults to embed_dims // 64 (the ViT head width of TimeSformer-B)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "params.npz")) as flat:
        model_sd, head_sd = split_artifact_params(
            {k: flat[k] for k in flat.files})
    embed_dims = model_sd["cls_token"].shape[-1]
    model = timesformer_from_state_dict(
        model_sd, manifest["num_frames"], manifest["img_size"],
        num_heads or embed_dims // 64)
    num_class, in_ch = head_sd["cls_head.weight"].shape
    head = ClassificationHead(num_class, in_ch)
    head.load_state_dict({k: torch.from_numpy(v) for k, v in head_sd.items()},
                         strict=True)
    return TorchPredictor(model, head, manifest, device, dtype)
