"""MaskFeat's cube masks, on the host.

A copy of ``videotransformer_tpu/data/mask_generator.py`` (the original
repo's mask_generator.py:23-107), which the port cannot import: importing
the JAX package's data modules runs its ``__init__``, which imports jax.
``CubeMaskGenerator`` draws a BEiT-style blockwise 2-D mask (a rejection
loop over rectangles with log-uniform aspect) and repeats it over a random
temporal span that does not overlap earlier spans, from a numpy Generator.
It returns ``(cube_mask (T', H', W') int32, cube_marker [[start, span],
...])``; ``pad_cube_marker`` pads a batch of markers to fixed shape.
"""

import math

import numpy as np


class CubeMaskGenerator:
    def __init__(self, input_size=(8, 14, 14), mask_ratio=0.4,
                 min_num_patches=16, max_num_patches=None, min_aspect=0.3,
                 max_aspect=None, rng=None):
        self.temporal, self.height, self.width = input_size
        self.num_patches = self.height * self.width
        self.num_masking_patches = int(self.num_patches * mask_ratio)
        self.num_masking_frames = int(self.temporal * mask_ratio)
        self.min_num_patches = min_num_patches
        self.max_num_patches = (self.num_masking_patches
                                if max_num_patches is None
                                else max_num_patches)
        max_aspect = max_aspect or 1 / min_aspect
        self.log_aspect_ratio = (math.log(min_aspect), math.log(max_aspect))
        self.rng = rng or np.random.default_rng()

    def get_shape(self):
        return self.temporal, self.height, self.width

    def _mask(self, mask, max_mask_patches):
        delta = 0
        for _attempt in range(10):
            # random.uniform(a, b) takes b < a (the reference relies on it
            # when fewer than min_num_patches remain); numpy's does not
            lo = min(self.min_num_patches, max_mask_patches)
            hi = max(self.min_num_patches, max_mask_patches)
            target_area = self.rng.uniform(lo, hi)
            aspect_ratio = math.exp(self.rng.uniform(*self.log_aspect_ratio))
            h = int(round(math.sqrt(target_area * aspect_ratio)))
            w = int(round(math.sqrt(target_area / aspect_ratio)))
            if w < self.width and h < self.height:
                top = int(self.rng.integers(0, self.height - h + 1))
                left = int(self.rng.integers(0, self.width - w + 1))
                region = mask[top:top + h, left:left + w]
                num_masked = region.sum()
                if 0 < h * w - num_masked <= max_mask_patches:
                    delta = int((region == 0).sum())
                    region[region == 0] = 1
                if delta > 0:
                    break
        return delta

    def __call__(self):
        time_marker = np.zeros(shape=self.temporal, dtype=np.int32)
        cube_mask = np.zeros(shape=self.get_shape(), dtype=np.int32)
        cube_marker = []
        temp_mask_count = 0
        while temp_mask_count < self.num_masking_frames:
            mask = np.zeros(shape=self.get_shape()[1:], dtype=np.int32)
            mask_count = 0
            while mask_count < self.num_masking_patches:
                max_mask_patches = min(
                    self.num_masking_patches - mask_count,
                    self.max_num_patches)
                delta = self._mask(mask, max_mask_patches)
                if delta == 0:
                    break
                mask_count += delta
            # a random temporal span; the reference's randint(0, temporal)
            # includes temporal
            start_frame = int(self.rng.integers(0, self.temporal + 1))
            accumulate_frames = int(self.rng.integers(
                1, self.num_masking_frames - temp_mask_count + 1))
            mask_count = 0
            for i in range(start_frame, start_frame + accumulate_frames):
                if i > self.temporal - 1:
                    break
                if time_marker[i] == 0:
                    time_marker[i] = 1
                    cube_mask[i] = mask
                    mask_count += 1
                else:
                    break
            temp_mask_count += mask_count
            if mask_count > 0:
                cube_marker.append([start_frame, mask_count])
        return cube_mask, cube_marker


def pad_cube_marker(cube_markers, max_cubes=None):
    """A batch of ragged cube_marker lists -> ((B, max_cubes, 2) int32, (B,)
    counts); max_cubes defaults to the longest list."""
    if max_cubes is None:
        max_cubes = max(1, max(len(m) for m in cube_markers))
    out = np.zeros((len(cube_markers), max_cubes, 2), dtype=np.int32)
    count = np.zeros((len(cube_markers),), dtype=np.int32)
    for i, markers in enumerate(cube_markers):
        for j, (s, n) in enumerate(markers[:max_cubes]):
            out[i, j, 0] = s
            out[i, j, 1] = n
        count[i] = min(len(markers), max_cubes)
    return out, count
