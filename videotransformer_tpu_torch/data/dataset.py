"""Kinetics: annotation parsing, temporal sampling, clip loading.

Port of ``videotransformer_tpu/data/dataset.py`` (the reference's
dataset.py):

- tab-separated ``path\\tclass_name`` annotation rows, the classmap json
  lookup and a per-class sample cap (``load_annotations``);
- ``__getitem__``: a temporal window from ``TemporalRandomCrop``,
  ``np.linspace(start, end - 1, num_frames)`` frame indices and one
  ``get_batch``; on a decode error another random index, at most
  ``max_decode_retries`` times in a row (None: forever, as the reference);
- ``raw_clips=True``: the decode resizes the short edge to the canonical
  height, and the clip is cropped or padded to the canonical (H, W) and
  returned as uint8 (T, H, W, C) (``canonicalize_raw_clip``); every
  augmentation then runs on the device (``data/device_augment.py``);
- the mim objective: a cube mask per clip, with HOG targets at the
  cube-centre frames on the host (``host_hog_targets``) or the clip before
  Normalize for HOG on the device.

A plain indexable of numpy samples, read by ``pipeline.Loader``.
"""

import json
import os
import random

import numpy as np

from videotransformer_tpu_torch.data.mask_generator import CubeMaskGenerator
from videotransformer_tpu_torch.data.video_reader import (
    DecordInit, VideoReader)

ASSETS_DIR = os.path.join(os.path.dirname(__file__), "assets")


def temporal_sampling(frames, start_idx, end_idx, num_samples):
    """Equal-interval index sampling (reference dataset.py:15-32)."""
    index = np.linspace(start_idx, end_idx, num_samples)
    index = np.clip(index, 0, frames.shape[0] - 1).astype(np.int64)
    return frames[index]


def load_annotation_data(data_file_path):
    with open(data_file_path, "r") as data_file:
        return json.load(data_file)


def get_class_labels(num_class, anno_pth=None):
    """The classmap {class name: id} and a zero count per class (reference
    dataset.py:53-63); by default the Kinetics-400 map, or Kinetics-600's
    above 400 classes (copies of the JAX package's assets)."""
    if anno_pth is None:
        anno_pth = os.path.join(
            ASSETS_DIR, "k600_classmap.json" if num_class > 400
            else "k400_classmap.json")
    class_labels_map = load_annotation_data(anno_pth)
    cls_sample_cnt = {cls: 0 for cls in class_labels_map}
    return class_labels_map, cls_sample_cnt


def load_annotations(ann_file, num_class, num_samples_per_cls, anno_pth=None):
    """[{"video": path, "label": id}] of the rows whose class id is below
    ``num_class``, at most ``num_samples_per_cls`` a class (reference
    dataset.py:66-93)."""
    dataset = []
    class_to_idx, cls_sample_cnt = get_class_labels(num_class, anno_pth)
    with open(ann_file, "r") as fin:
        for line in fin:
            line_split = line.strip().split("\t")
            label = line_split[1:]
            if len(label) != 1:
                raise ValueError(f"want one label in line: {line!r}")
            class_name = label[0]
            class_index = int(class_to_idx[class_name])
            if class_index < num_class and \
                    cls_sample_cnt[class_name] < num_samples_per_cls:
                dataset.append({"video": line_split[0],
                                "label": class_index})
                cls_sample_cnt[class_name] += 1
    return dataset


def canonicalize_raw_clip(video, canonical_hw=(256, 342)):
    """The short-edge-resized decode (T, H, W, C) uint8, centre-cropped or
    padded (with zeros, on the right and bottom) to (T, ch, cw, C): the
    fixed shape of the device augment and of raw-uint8 serving
    (dataset.py:80-99)."""
    ch, cw = canonical_hw
    t, h, w, c = video.shape
    if w >= cw:
        x0 = (w - cw) // 2
        video = video[:, :ch, x0:x0 + cw]
    else:
        pad = np.zeros((t, min(h, ch), cw, c), np.uint8)
        x0 = (cw - w) // 2
        pad[:, :, x0:x0 + w] = video[:, :ch]
        video = pad
    if video.shape[1] < ch:
        pad = np.zeros((t, ch, cw, c), np.uint8)
        pad[:, :video.shape[1]] = video
        video = pad
    return np.ascontiguousarray(video)


class Kinetics:
    """Kinetics video dataset (reference dataset.py:122-208).

    Args:
        configs: namespace with num_class, num_samples_per_cls, num_frames,
            objective, classmap_path (and optionally video_root, img_size).
        annotation_path: tab-separated annotation file; relative rows
            resolve against ``configs.video_root``, else the file's own
            directory.
        transform: clip transform (a [pre, post] pair for mim).
        temporal_sample: a ``TemporalRandomCrop``.
        host_hog_targets: mim: HOG targets on the host (else the clip
            before Normalize, for HOG on the device).
        raw_clips: canonical uint8 clips for the device augment.
        max_decode_retries: bound of the resample loop (None: forever).
    """

    def __init__(self, configs, annotation_path, transform=None,
                 temporal_sample=None, host_hog_targets=False,
                 raw_clips=False, canonical_hw=(256, 342),
                 max_decode_retries=None):
        self.configs = configs
        self.data = load_annotations(
            annotation_path, configs.num_class, configs.num_samples_per_cls,
            getattr(configs, "classmap_path", None))
        self.video_root = (getattr(configs, "video_root", None)
                           or os.path.dirname(os.path.abspath(annotation_path)))
        self.transform = transform
        self.temporal_sample = temporal_sample
        self.target_video_len = configs.num_frames
        self.objective = configs.objective
        self.v_decoder = DecordInit()
        self.host_hog_targets = host_hog_targets
        self.raw_clips = raw_clips
        self.canonical_hw = canonical_hw
        self.max_decode_retries = max_decode_retries
        if self.objective == "mim":
            # mask grid = img_size / (patch stride 4 x pooling downsample 4)
            img_size = getattr(configs, "img_size", 224)
            if img_size % 16:
                raise ValueError(
                    f"mim objective requires img_size % 16 == 0 (patch "
                    f"stride 4 x pooling downsample 4); got {img_size}")
            self.mask_grid = img_size // 16
            # the minimum patch count is clamped to the mask budget, so
            # that tiny grids do not fail every draw (dataset.py:160-170)
            budget = int(self.mask_grid * self.mask_grid * 0.4)
            self._cube_generator = CubeMaskGenerator(
                input_size=(self.target_video_len // 2, self.mask_grid,
                            self.mask_grid),
                min_num_patches=min(16, budget))

    def mask_generator(self):
        """A cube-mask draw, redrawn while empty, at most 20 draws: the
        last draw is returned even when it is empty (dataset.py:172-183)."""
        for _ in range(20):
            mask, cube_marker = self._cube_generator()
            if mask.any():
                return mask, cube_marker
        return mask, cube_marker

    def _decode(self, index):
        """(T, H, W, C) uint8 frames of sample ``index``, or of a random
        other one after each decode error (dataset.py:185-213)."""
        attempts = 0
        while True:
            path = os.path.join(self.video_root, self.data[index]["video"])
            try:
                if self.raw_clips:
                    reader = VideoReader(path,
                                         short_edge=self.canonical_hw[0])
                else:
                    reader = self.v_decoder(path)
                try:
                    start, end = self.temporal_sample(len(reader))
                    if end - start < self.target_video_len:
                        raise IOError(f"{path}: {end - start} frames, fewer "
                                      f"than {self.target_video_len}")
                    indices = np.linspace(start, end - 1,
                                          self.target_video_len, dtype=int)
                    return index, reader.get_batch(indices)
                finally:
                    reader.close()
            except OSError as e:
                print(e)
                attempts += 1
                if (self.max_decode_retries is not None
                        and attempts > self.max_decode_retries):
                    raise RuntimeError(
                        f"decode failed for {self.max_decode_retries} "
                        f"resampled clips in a row (last: {path})") from e
                index = random.randint(0, len(self.data) - 1)

    def __getitem__(self, index):
        index, video = self._decode(index)
        if self.raw_clips:
            clip = canonicalize_raw_clip(video, self.canonical_hw)
            if self.objective == "mim":
                mask, cube_marker = self.mask_generator()
                return clip, mask, cube_marker
            return clip, self.data[index]["label"]

        # (T, H, W, C) -> (T, C, H, W), the reference's layout
        video = np.ascontiguousarray(
            video.transpose(0, 3, 1, 2)).astype(np.float32)
        if self.objective != "mim":
            if self.transform is not None:
                self.transform.randomize_parameters()
                video = self.transform(video)
            return video, self.data[index]["label"]

        post_transform = None
        if self.transform is not None:
            pre_transform, post_transform = self.transform
            pre_transform.randomize_parameters()
            video = pre_transform(video)
        mask, cube_marker = self.mask_generator()
        post_video = video if post_transform is None \
            else post_transform(video)
        if not self.host_hog_targets:
            return post_video, video, mask, cube_marker
        from videotransformer_tpu_torch.data.hog import extract_hog_features_np

        hog_inputs = video.transpose(0, 2, 3, 1)
        hog = np.zeros((self.target_video_len, self.mask_grid, self.mask_grid,
                        2 * 2 * 3 * 9), dtype=np.float32)
        for start_frame, span_frame in cube_marker:
            center = start_frame * 2 + span_frame * 2 // 2
            hog[center] = extract_hog_features_np(hog_inputs[center])
        return post_video, hog, mask, cube_marker

    def __len__(self):
        return len(self.data)
