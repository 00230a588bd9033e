"""MaskFeat's cube masks for the traffic generator.

A frozen copy of the port's ``data/mask_generator.py`` (the original
repo's mask_generator.py:23-107, BEiT-style blockwise masks repeated over
a random temporal span) and of the dataset's draw rule (``data/
dataset.py``: redrawn while empty, at most 20 draws; at least
min(16, 40% of the grid) patches a block), drawn from a numpy Generator
that the benchmark seeds."""

import math

import numpy as np


class CubeMaskGenerator:
    def __init__(self, input_size, mask_ratio=0.4, min_num_patches=16,
                 min_aspect=0.3, rng=None):
        self.temporal, self.height, self.width = input_size
        self.num_masking_patches = int(self.height * self.width * mask_ratio)
        self.num_masking_frames = int(self.temporal * mask_ratio)
        self.min_num_patches = min_num_patches
        self.max_num_patches = self.num_masking_patches
        self.log_aspect_ratio = (math.log(min_aspect),
                                 math.log(1 / min_aspect))
        self.rng = rng

    def _mask(self, mask, max_mask_patches):
        delta = 0
        for _ in range(10):
            lo = min(self.min_num_patches, max_mask_patches)
            hi = max(self.min_num_patches, max_mask_patches)
            target_area = self.rng.uniform(lo, hi)
            aspect = math.exp(self.rng.uniform(*self.log_aspect_ratio))
            h = int(round(math.sqrt(target_area * aspect)))
            w = int(round(math.sqrt(target_area / aspect)))
            if w < self.width and h < self.height:
                top = int(self.rng.integers(0, self.height - h + 1))
                left = int(self.rng.integers(0, self.width - w + 1))
                region = mask[top:top + h, left:left + w]
                if 0 < h * w - region.sum() <= max_mask_patches:
                    delta = int((region == 0).sum())
                    region[region == 0] = 1
                if delta > 0:
                    break
        return delta

    def __call__(self):
        time_marker = np.zeros(self.temporal, dtype=np.int32)
        cube = np.zeros((self.temporal, self.height, self.width), np.int32)
        markers, frames = [], 0
        while frames < self.num_masking_frames:
            mask = np.zeros((self.height, self.width), dtype=np.int32)
            count = 0
            while count < self.num_masking_patches:
                delta = self._mask(mask, min(
                    self.num_masking_patches - count, self.max_num_patches))
                if delta == 0:
                    break
                count += delta
            start = int(self.rng.integers(0, self.temporal + 1))
            span = int(self.rng.integers(
                1, self.num_masking_frames - frames + 1))
            n = 0
            for i in range(start, start + span):
                if i > self.temporal - 1 or time_marker[i]:
                    break
                time_marker[i] = 1
                cube[i] = mask
                n += 1
            frames += n
            if n > 0:
                markers.append([start, n])
        return cube, markers


def draw(rng, clips, grid_t, grid, max_cubes=8):
    """Masks (clips, grid_t, grid, grid) int32, cube markers (clips,
    max_cubes, 2) int32 and counts (clips,) int32."""
    budget = int(grid * grid * 0.4)
    gen = CubeMaskGenerator((grid_t, grid, grid),
                            min_num_patches=min(16, budget), rng=rng)
    masks, markers = [], []
    for _ in range(clips):
        for _ in range(20):
            mask, marker = gen()
            if mask.any():
                break
        masks.append(mask)
        markers.append(marker)
    out = np.zeros((clips, max_cubes, 2), np.int32)
    count = np.zeros((clips,), np.int32)
    for i, m in enumerate(markers):
        for j, (s, n) in enumerate(m[:max_cubes]):
            out[i, j] = (s, n)
        count[i] = min(len(m), max_cubes)
    return np.stack(masks).astype(np.int32), out, count
