"""The original repo's host helpers (utils.py), on torch.distributed.

Port of ``videotransformer_tpu/utils/helpers.py``. The rank helpers
(:17-36) ask JAX's process set there; here the world is the initialised
``torch.distributed`` process group, and a run without one is rank 0 of 1.
``timeit_wrapper``, ``build_param_groups``, ``denormalize`` and
``show_processed_image`` (:38-106) keep their numerics; the parameter
groups are those ``training/optimizer.py`` applies. ``resolve_device`` is
the entry points' device check.
"""

import functools
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from videotransformer_tpu_torch.training.optimizer import (
    SKIP_KEYWORDS, no_decay)


def is_dist_avail_and_initialized():
    return dist.is_available() and dist.is_initialized()


def get_world_size():
    return dist.get_world_size() if is_dist_avail_and_initialized() else 1


def get_rank():
    return dist.get_rank() if is_dist_avail_and_initialized() else 0


def is_main_process():
    return get_rank() == 0


def print_on_rank_zero(*args, **kwargs):
    if is_main_process():
        print(*args, **kwargs, flush=True)


def resolve_device(name):
    """``torch.device(name)``; a CUDA device needs a visible card, else
    RuntimeError: an entry point never falls back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} asked for but no CUDA device "
                           "is visible (--device cpu runs on the CPU)")
    return device


def timeit_wrapper(func):
    """reference utils.py:36-40."""

    @functools.wraps(func)
    def with_time(*args, **kwargs):
        start = time.perf_counter()
        result = func(*args, **kwargs)
        print(f"{func.__name__} cost time {time.perf_counter() - start:.3f}s")
        return result

    return with_time


def build_param_groups(params, skip_keywords=SKIP_KEYWORDS):
    """Split parameters into (no_decay, decay) name lists by the rule of
    reference utils.py:46-66 and optimizer.py:43-62, ``no_decay`` of the
    trainer's optimizer: 1-D tensors, names ending in ``bias`` and names
    holding a skip keyword do not decay. ``params``: ``named_parameters()``
    or a state dict."""
    items = params.items() if hasattr(params, "items") else params
    groups = ([], [])
    for name, p in items:
        groups[0 if no_decay(name, p, skip_keywords) else 1].append(name)
    return groups


def denormalize(data, mean, std):
    """Invert Normalize to uint8 pixels (reference utils.py:69-97).

    data: (..., C, H, W) normalized floats; mean/std per channel.
    """
    data = np.asarray(data, dtype=np.float32)
    mean = np.asarray(mean, dtype=np.float32).reshape(-1, 1, 1)
    std = np.asarray(std, dtype=np.float32).reshape(-1, 1, 1)
    out = (data * std + mean) * 255.0
    return np.clip(out + 0.5, 0, 255).astype(np.uint8)


def show_processed_image(imgs, save_dir, mean, std, index=0):
    """Save a grid of the first 5 frames (reference utils.py:100-128) with
    matplotlib, imported here: the card's machine may lack it.

    imgs: (T, H, W, C) or (B, T, H, W, C) normalized floats.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    imgs = np.asarray(imgs)
    if imgs.ndim == 5:
        imgs = imgs[index]
    n = min(5, imgs.shape[0])
    fig, axes = plt.subplots(1, n, figsize=(3 * n, 3))
    if n == 1:
        axes = [axes]
    for i in range(n):
        frame = denormalize(imgs[i].transpose(2, 0, 1), mean, std)
        axes[i].imshow(frame.transpose(1, 2, 0))
        axes[i].axis("off")
    path = os.path.join(save_dir, f"processed_frames_{index}.png")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return path
