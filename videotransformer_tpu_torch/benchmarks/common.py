"""What the port's measuring scripts share: the JAX scripts' configs and
batches, the models, the tiny geometry of the CPU runs, and timing.

The JAX scripts (``benchmarks/*.py``) each spell these out; here they are
written once. ``model="b16"`` is the scripts' full width (TimeSformer-B/16
8x224, ViViT-B 16x224, MViT-B 16x224, 400 classes); ``model="tiny"`` is a
geometry for runs on the CPU (2 frames at 32², embed 32, 4 heads, 2
layers; MaskFeat at 4 frames, depth 4, so that its two q-pool stages
exist). Timing: CUDA events on a card, the host clock on the CPU, where a
device metric is not measured (None).
"""

import contextlib
import json
import time
from types import SimpleNamespace
from unittest import mock

import numpy as np
import torch

from videotransformer_tpu_torch.models.maskfeat import MaskFeat
from videotransformer_tpu_torch.models.timesformer import TimeSformer
from videotransformer_tpu_torch.models.vivit import ViViT
from videotransformer_tpu_torch.ops.blocks import ClassificationHead
from videotransformer_tpu_torch.training import trainer as trainer_mod

NUM_CLASS = 400
TINY = dict(img_size=32, patch_size=16, embed_dims=32, num_heads=4,
            num_transformer_layers=2)
TINY_MIM = dict(depth=4, patch_embed_dim=32,
                embed_dim_mul=((1, 2.0), (3, 2.0)),
                atten_head_mul=((1, 2.0), (3, 2.0)))
MVIT_POOL = ((1, 1, 2, 2), (3, 1, 2, 2))  # the trainer's two q-pool stages
RAW_HW = {"b16": (256, 342), "tiny": (40, 54)}  # uint8 clips' frame size


def frames(model, b16_frames):
    """A clip's frames: the scripts' count at full width; on the tiny
    geometry 2 for an 8-frame clip and 4 for a 16-frame one (ViViT's tube
    and MaskFeat's patch take 2 frames)."""
    if model == "b16":
        return b16_frames
    return 2 if b16_frames == 8 else 4


def img_size(model):
    return 224 if model == "b16" else TINY["img_size"]


def working_dtype(device):
    """bf16 on a card (the kernels' type), fp32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def device_name(device):
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def emit(line):
    print(json.dumps(line), flush=True)


@contextlib.contextmanager
def tiny_models(model):
    """The trainer's ``build_model`` on the tiny geometry while the context
    is open (nothing changes for ``model="b16"``)."""
    if model == "b16":
        yield
        return

    def build(c, mesh=None):
        if c.objective == "mim" or c.arch == "mvit":
            return MaskFeat(img_size=c.img_size, num_frames=c.num_frames,
                            pool_q_stride_size=MVIT_POOL,
                            feature_dim=2 * 2 * 2 * 3 * 9, **TINY_MIM)
        return TimeSformer(num_frames=c.num_frames,
                           attention_type=c.attention_type,
                           remat=bool(getattr(c, "remat", False)), **TINY)

    with mock.patch.object(trainer_mod, "build_model", build):
        yield


def finetune_configs(model, batch_size=8, remat=False):
    """The JAX scripts' supervised TimeSformer-B finetune config: AdamW,
    clip 1.0, mixup, bf16 compute, the device augment (uint8 clips)."""
    return SimpleNamespace(
        objective="supervised", arch="timesformer",
        attention_type="divided_space_time", num_class=NUM_CLASS,
        num_frames=frames(model, 8), img_size=img_size(model),
        batch_size=batch_size, optim_type="adamw", lr=5e-3,
        lr_schedule="cosine", warmup_epochs=5, min_lr=1e-6,
        weight_decay=0.05, weight_decay_end=0.05, clip_grad=1.0, seed=0,
        mixup=True, eval_metrics="finetune", layer_decay=1.0, use_fp16=True,
        device_augment=True, data_statics="kinetics", remat=remat)


def maskfeat_configs(model, batch_size=8):
    """The JAX scripts' MaskFeat pretraining config on MViT-B 16x224."""
    return SimpleNamespace(
        objective="mim", arch="mvit", attention_type="divided_space_time",
        num_class=NUM_CLASS, num_frames=frames(model, 16),
        img_size=img_size(model), batch_size=batch_size, optim_type="adamw",
        lr=8e-4, lr_schedule="cosine", warmup_epochs=5, min_lr=1e-6,
        weight_decay=0.05, weight_decay_end=0.05, clip_grad=0.0, seed=0,
        mixup=False, eval_metrics="finetune", layer_decay=0.75, use_fp16=True)


def finetune_batch(rng, cfg, model, batch_size, device):
    """uint8 clips (B, T, H, W, 3) and labels, on ``device``."""
    h, w = RAW_HW[model]
    raw = (rng.rand(batch_size, cfg.num_frames, h, w, 3) * 255).astype(
        np.uint8)
    labels = (np.arange(batch_size) % cfg.num_class).astype(np.int32)
    return {"raw_video": torch.from_numpy(raw).to(device),
            "label": torch.from_numpy(labels).to(device)}


def maskfeat_batch(rng, cfg, batch_size, device):
    """The JAX scripts' mim batch: a clip, its pixels before Normalize, a
    random token mask and two cubes (HOG targets computed by the trainer
    on the device)."""
    t, s = cfg.num_frames, cfg.img_size
    cubes = [[1, 2], [5, 1]] if t == 16 else [[0, 1], [1, 1]]
    batch = {
        "video": rng.rand(batch_size, t, 3, s, s).astype(np.float32),
        "raw": (rng.rand(batch_size, t, 3, s, s) * 255).astype(np.float32),
        "mask": (rng.rand(batch_size, t // 2, s // 16, s // 16) > 0.6
                 ).astype(np.int32),
        "cube_marker": np.tile(np.array([cubes + [[0, 0]] * 6], np.int32),
                               (batch_size, 1, 1)),
        "cube_count": np.full((batch_size,), 2, np.int32)}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def video_model(arch, attention_type, model, num_frames, device):
    """A TimeSformer or ViViT and its 400-class head, the JAX package's
    initialisation (seeds 0 and 1), eval mode, in the working dtype on
    ``device``."""
    geometry = {} if model == "b16" else dict(TINY)
    if arch == "vivit":
        if model != "b16":
            geometry["num_time_transformer_layers"] = 2
        net = ViViT(num_frames=num_frames, attention_type=attention_type,
                    **geometry)
    else:
        net = TimeSformer(num_frames=num_frames,
                          attention_type=attention_type, **geometry)
    head = ClassificationHead(NUM_CLASS, net.cls_token.shape[-1])
    net.reset_parameters(torch.Generator().manual_seed(0))
    head.reset_parameters(torch.Generator().manual_seed(1))
    dtype = working_dtype(device)
    return net.to(device, dtype).eval(), head.to(device, dtype).eval()


def mvit_model(model, device):
    """MViT-B (MaskFeat's trunk, 16x224, the trainer's pooling), eval mode,
    in the working dtype on ``device``."""
    extra = {} if model == "b16" else dict(TINY_MIM)
    net = MaskFeat(num_frames=frames(model, 16), img_size=img_size(model),
                   pool_q_stride_size=MVIT_POOL, feature_dim=216, **extra)
    net.reset_parameters(torch.Generator().manual_seed(0))
    return net.to(device, working_dtype(device)).eval()


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def event_ms(fn, device, reps=5, warmup=2):
    """Mean ms of one call of ``fn`` over ``reps`` calls after ``warmup``:
    CUDA events around the calls as the host issues them on a card, the
    host clock to a synchronize on the CPU."""
    for _ in range(warmup):
        fn()
    sync(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def clock_ms(fn, device, reps=5, warmup=2):
    """Mean ms of one call on the host clock, ``reps`` calls after
    ``warmup`` with one synchronize at the end (the JAX scripts' timing)."""
    for _ in range(warmup):
        fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / reps * 1e3
