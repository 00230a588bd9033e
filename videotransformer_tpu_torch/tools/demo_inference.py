"""Demo-clip inference: the reference notebook's path on the port.

Port of ``videotransformer_tpu/tools/demo_inference.py``: decode (the
native decoder or OpenCV, ``data.video_reader``) -> Resize(-1, 256) ->
ThreeCrop(224) -> Normalize(0.45/0.225) -> TimeSformer or ViViT -> per-crop
logits -> mean over the 3 crops -> argmax -> classmap lookup.

    python -m videotransformer_tpu_torch.tools.demo_inference \\
        --video videotransformer_tpu/data/assets/demo/pulse_circle_0.mp4 \\
        --arch timesformer [--ckpt K400.pth] [--num_frames 8] [--device cpu]

``--ckpt`` is a checkpoint of the original repo (``init_from_kinetics_
pretrain``, its ``cls_head.*`` keys into the head). ``--classmap`` defaults
to the port's ``data/assets/k{num_class}_classmap.json``. The model runs in
bf16 on the card (``--device cuda``, the default) and in fp32 on the CPU.
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from videotransformer_tpu_torch.data.transforms import (
    eval_transform_clip, temporal_window)
from videotransformer_tpu_torch.data.video_reader import VideoReader
from videotransformer_tpu_torch.models import convert
from videotransformer_tpu_torch.models.timesformer import TimeSformer
from videotransformer_tpu_torch.models.vivit import ViViT
from videotransformer_tpu_torch.ops.blocks import ClassificationHead

ASSETS_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data",
                          "assets")
MEAN, STD = (0.45,) * 3, (0.225,) * 3


def load_clip(video_path, num_frames, frame_interval, mean, std, rng=None):
    """Decode + eval-transform one clip -> (3, T, C, 224, 224) float32. The
    temporal window is drawn from the numpy Generator ``rng`` (a fresh one
    when None). As in the reference notebook, the frames are spread over the
    window's length from frame 0."""
    rng = np.random.default_rng() if rng is None else rng
    vr = VideoReader(video_path)
    try:
        start, end = temporal_window(len(vr), num_frames * frame_interval,
                                     rng)
        indices = np.linspace(0, end - start - 1, num_frames, dtype=int)
        return eval_transform_clip(vr.get_batch(indices), mean, std)
    finally:
        vr.close()


def build_model(arch, num_frames, attention_type=None):
    """TimeSformer-B (divided by default) or ViViT-B (fact_encoder by
    default) at 224, as the JAX tool's ``build_model``: no ``img_size``."""
    if arch == "timesformer":
        return TimeSformer(num_frames=num_frames, attention_type=(
            attention_type or "divided_space_time"))
    if arch == "vivit":
        return ViViT(num_frames=num_frames,
                     attention_type=attention_type or "fact_encoder")
    raise ValueError(arch)


def init_model_and_head(model, head, seed=0):
    """The JAX package's initialisation of both, the model from ``seed``
    and the head from ``seed + 1`` (the JAX tool's PRNGKey(0) and (1))."""
    model.reset_parameters(torch.Generator().manual_seed(seed))
    head.reset_parameters(torch.Generator().manual_seed(seed + 1))


def load_kinetics_checkpoint(model, head, ckpt):
    """A checkpoint of the original repo into the model
    (``init_from_kinetics_pretrain``) and its ``cls_head.*`` keys, after
    ``replace_state_dict``, into the head."""
    payload = convert.read_checkpoint(ckpt)
    convert.init_from_kinetics_pretrain(model, payload)
    sd = convert.replace_state_dict(convert.load_torch_state_dict(payload))
    head_sd = {k: v for k, v in sd.items() if k.startswith("cls_head")}
    if head_sd:
        convert.merge_state_dict(head, head_sd, verbose=False)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--video", required=True)
    p.add_argument("--arch", default="timesformer",
                   choices=["timesformer", "vivit"])
    p.add_argument("--attention_type", default=None)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--num_frames", type=int, default=8)
    p.add_argument("--frame_interval", type=int, default=32)
    p.add_argument("--num_class", type=int, default=400)
    p.add_argument("--classmap", default=None,
                   help="JSON {class name: id}; default the port's "
                        "data/assets/k{num_class}_classmap.json")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    classmap = args.classmap or os.path.join(
        ASSETS_DIR, f"k{args.num_class}_classmap.json")
    with open(classmap) as f:
        idx_to_class = {int(v): k for k, v in json.load(f).items()}
    device = torch.device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32

    model = build_model(args.arch, args.num_frames, args.attention_type)
    head = ClassificationHead(args.num_class, model.cls_token.shape[-1])
    init_model_and_head(model, head)
    if args.ckpt:
        load_kinetics_checkpoint(model, head, args.ckpt)
    model = model.to(device, dtype).eval()
    head = head.to(device).eval()

    clip = torch.from_numpy(load_clip(args.video, args.num_frames,
                                      args.frame_interval, MEAN, STD))
    clip = clip.to(device, dtype)  # (3, T, C, H, W)

    @torch.inference_mode()
    def infer():
        logits = head(model(clip).float())
        return logits.reshape(-1, 3, args.num_class).mean(dim=1)

    sync = torch.cuda.synchronize if device.type == "cuda" else lambda: None
    t0 = time.perf_counter()
    infer()
    sync()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    logits = infer()
    sync()
    run_ms = 1000 * (time.perf_counter() - t0)
    pred = int(logits[0].argmax())
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"prediction: {pred} ({idx_to_class.get(pred, '?')})")
    print(f"first call {first_s:.1f}s (kernel builds included), then "
          f"{run_ms:.1f}ms for 3 crops on {name}")
    return logits


if __name__ == "__main__":
    main()
