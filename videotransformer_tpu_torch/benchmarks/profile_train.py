"""Break the supervised train step of the port into timed pieces.

Twin of ``benchmarks/profile_train.py`` (:42-116). Times, in CUDA-event ms
(after warm-up; the host clock on the CPU), for a batch of 8 TimeSformer-B
8x224 clips in bf16 compute:

  fwd (train)   model forward with DropPath, head and soft-target loss
  fwd (eval)    the same in eval mode
  fwd+bwd       the forward and its backward
  augment       the device augment of 8 uint8 clips (crop, resize, flip,
                color jitter, normalize)
  mixup         the batched mixup
  opt           the trainer's AdamW update alone, on the gradients of a
                backward
  full step     the trainer's ``train_step`` (augment, mixup, forward,
                backward, clip, update)

and prints one JSON line with them.

    python -m videotransformer_tpu_torch.benchmarks.profile_train \\
        [--batch 8] [--device cpu --model tiny]
"""

import argparse

import numpy as np
import torch

from videotransformer_tpu_torch.benchmarks import common
from videotransformer_tpu_torch.training.trainer import (
    VideoTransformerTrainer, soft_target_cross_entropy)
from videotransformer_tpu_torch.utils.helpers import resolve_device

LR, WD = 5e-3, 0.05


def run(args):
    device = resolve_device(args.device)
    model, B = args.model, args.batch
    cfg = common.finetune_configs(model, B)
    with common.tiny_models(model):
        tr = VideoTransformerTrainer(cfg, device)
    rng = np.random.RandomState(0)
    batch = common.finetune_batch(rng, cfg, model, B, device)
    s = cfg.img_size
    video = torch.from_numpy(rng.rand(B, cfg.num_frames, 3, s, s).astype(
        np.float32)).to(device)
    labels = batch["label"]
    soft = torch.nn.functional.one_hot(labels.long(), cfg.num_class).float()
    dtype = tr.dtype
    net, head, g = tr.model, tr.cls_head, tr.generator

    def loss(train):
        net.train(train)
        feats = net(video.to(dtype), g if train else None)
        return soft_target_cross_entropy(head(feats), soft)

    def fwd_bwd():
        tr.optimizer.zero_grad()
        loss(True).backward()

    def step():
        tr.train_step(batch, LR, WD)

    with torch.no_grad():
        times = {"fwd_train_ms": common.event_ms(lambda: loss(True), device),
                 "fwd_eval_ms": common.event_ms(lambda: loss(False), device)}
    times["fwd_bwd_ms"] = common.event_ms(fwd_bwd, device)
    times["augment_ms"] = common.event_ms(
        lambda: tr._augment(batch["raw_video"]), device)
    times["mixup_ms"] = common.event_ms(
        lambda: tr.mixup_fn(video, labels, g), device)
    fwd_bwd()  # gradients for the update alone
    times["opt_ms"] = common.event_ms(lambda: tr.optimizer.step(LR, WD),
                                      device)
    times["full_step_ms"] = common.event_ms(step, device)
    names = {"fwd_train_ms": "fwd (train, DropPath)", "fwd_eval_ms":
             "fwd (eval)", "fwd_bwd_ms": "fwd+bwd", "augment_ms": "augment",
             "mixup_ms": "mixup", "opt_ms": "opt (AdamW update alone)",
             "full_step_ms": "full train step"}
    for key, label in names.items():
        print(f"{label:25s}: {times[key]:8.2f} ms")
    line = {"config": f"profile_train_timesformer_b_b{B}",
            "device": common.device_name(device),
            "timer": "cuda_events" if device.type == "cuda" else "host_clock",
            **times}
    common.emit(line)
    return line


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--model", choices=("b16", "tiny"), default="b16")
    return ap.parse_args(argv)


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
