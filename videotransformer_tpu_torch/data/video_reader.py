"""Random-access video decode on the host through OpenCV.

Port of the ``cv2`` backend of ``videotransformer_tpu/data/video_reader.py``
(the FFmpeg reader built from ``videotransformer_tpu/native`` is not ported).
The API mirrors decord's: ``len()`` and ``get_batch(indices)`` -> uint8
(N, H, W, C) RGB. Random access reads forward with ``grab()`` for short
skips and seeks for long ones.
"""

import os

import numpy as np


class VideoReader:
    def __init__(self, path):
        import cv2

        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self._cv2 = cv2
        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise IOError(f"cv2 could not open video {path}")
        self.path = path
        self.num_frames = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self._pos = 0

    def __len__(self):
        return self.num_frames

    def _read_at(self, idx):
        if idx < self._pos or idx > self._pos + 64:
            self.cap.set(self._cv2.CAP_PROP_POS_FRAMES, idx)
            self._pos = idx
        while self._pos < idx:
            self.cap.grab()
            self._pos += 1
        ok, frame = self.cap.read()
        self._pos += 1
        if not ok:
            raise IOError(f"decode failure at frame {idx} of {self.path}")
        return frame[:, :, ::-1]  # BGR -> RGB

    def get_batch(self, indices):
        indices = np.asarray(indices, dtype=np.int64)
        frames = [None] * len(indices)
        for o in np.argsort(indices, kind="stable"):
            frames[o] = self._read_at(int(indices[o]))
        return np.ascontiguousarray(np.stack(frames))

    def close(self):
        self.cap.release()
