"""The reference notebook's eval transform, on the host in PyTorch.

Port of the eval chain of ``videotransformer_tpu/data/transforms.py``:
Resize(-1, 256) -> ThreeCrop(224) -> ToTensor -> Normalize, in that order.
The resize is ``F.interpolate`` (bilinear, align_corners=False, no
antialias): the operation that ``data/interpolation.py`` of the JAX package
reproduces as two weight matmuls.
"""

import numpy as np
import torch
import torch.nn.functional as F

SHORT_EDGE = 256  # Resize(-1, 256) of the notebook's eval chain


def short_edge_size(h, w, short):
    """Output (h, w) of a short-edge resize (interpolation.py:90-101)."""
    if h <= w:
        return short, int(short * w / h)
    return int(short * h / w), short


def three_crop(imgs, size):
    """Left, right and centre square crops of (..., H, W) -> (3, ..., size,
    size) (transforms.py:397-425)."""
    h, w = imgs.shape[-2:]
    if size > h or size > w:
        raise ValueError(f"Requested crop size {size} is bigger than input "
                         f"size {(h, w)}")
    y, xc = (h - size) // 2, (w - size) // 2
    return torch.stack([imgs[..., y:y + size, x:x + size]
                        for x in (0, w - size, xc)])


def temporal_window(total_frames, size, rng):
    """A random window of ``size`` frames drawn from the numpy Generator
    ``rng`` -> (begin, end) (transforms.py:428-438)."""
    rand_end = max(0, total_frames - size - 1)
    begin = int(rng.integers(0, rand_end + 1))
    return begin, min(begin + size, total_frames)


def eval_transform_clip(video, mean, std, img_size=224):
    """(T, H, W, C) uint8 frames -> Resize(-1, 256) -> ThreeCrop ->
    ToTensor -> Normalize -> (3, T, C, img_size, img_size) float32 numpy."""
    x = torch.from_numpy(np.ascontiguousarray(video)).permute(0, 3, 1, 2)
    x = x.float()
    size = short_edge_size(*x.shape[-2:], SHORT_EDGE)
    if size != tuple(x.shape[-2:]):
        x = F.interpolate(x, size=size, mode="bilinear", align_corners=False)
    crops = three_crop(x, img_size) / 255
    mean = torch.tensor(mean, dtype=torch.float32).view(-1, 1, 1)
    std = torch.tensor(std, dtype=torch.float32).view(-1, 1, 1)
    return ((crops - mean) / std).numpy()
