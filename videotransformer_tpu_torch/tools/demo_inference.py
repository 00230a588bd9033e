"""Demo-clip loading: the reference notebook's decode and eval transform.

Port of ``videotransformer_tpu/tools/demo_inference.py::load_clip`` over the
port's own ``data.transforms`` and ``data.video_reader`` (OpenCV decode).
"""

import numpy as np

from videotransformer_tpu_torch.data.transforms import (
    eval_transform_clip, temporal_window)
from videotransformer_tpu_torch.data.video_reader import VideoReader


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
