"""Random-access video decode on the host.

Port of ``videotransformer_tpu/data/video_reader.py``. Two backends, with
the API of decord's reader: ``len()``, ``fps`` and ``get_batch(indices)``
-> uint8 (N, H, W, C) RGB in request order.

- ``"native"``: the port's FFmpeg decoder (``native/videodec.cpp``, built
  with g++ at first use and bound with ctypes): seek to the keyframe before
  a target, decode forward, convert to RGB24 with swscale, which also does
  the short-edge resize.
- ``"cv2"``: OpenCV's ``VideoCapture``: ``grab()`` forward for short
  skips, a seek for long ones; the short-edge resize with ``INTER_AREA``.

``VideoReader(path, backend="auto")`` opens with the native decoder where
it builds or loads, as the JAX package's ``auto`` does, else with OpenCV.
The choice is made once per process (``auto_backend``). Where JAX's
``auto`` meets a failed build, every open raises (its ``_load_native``
guards only the import; the build runs at the reader's first open); the
port's gives way to OpenCV and prints one line that names the compiler's
error. ``short_edge`` resizes each decoded frame so that its short edge
has that size, the long edge truncated (video_reader.py:72-81).
"""

import os
import threading

import numpy as np

from videotransformer_tpu_torch.data.interpolation import short_edge_size
from videotransformer_tpu_torch.native import videodec

BACKENDS = ("auto", "native", "cv2")

_auto_lock = threading.Lock()
_auto = None  # (backend, the build error or None), decided at first use


def _error_line(error):
    """The compiler's first line that names an error, else its last line,
    else the error's message."""
    text = getattr(error, "output", "") or str(error)
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    named = [ln for ln in lines if "error" in ln.lower()]
    if named:
        return named[0]
    return lines[-1] if lines else repr(error)


def auto_backend():
    """``(backend, error)``: the backend that ``backend="auto"`` opens with
    in this process, ``"native"`` where the decoder library builds or
    loads, else ``"cv2"`` with the compiler's (or loader's) error line. The
    first call decides, under a lock, and prints the line when it is
    cv2."""
    global _auto
    with _auto_lock:
        if _auto is None:
            try:
                videodec.get_lib()
                _auto = ("native", None)
            except (videodec.DecoderBuildError, OSError) as e:
                _auto = ("cv2", _error_line(e))
                print(f"video_reader: the native decoder is unavailable, "
                      f"backend=auto decodes with OpenCV: {_auto[1]}",
                      flush=True)
        return _auto


class CV2Reader:
    """The ``cv2`` backend."""

    def __init__(self, path, short_edge=0):
        import cv2

        self._cv2 = cv2
        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise IOError(f"cv2 could not open video {path}")
        self.path = path
        self.num_frames = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.fps = float(self.cap.get(cv2.CAP_PROP_FPS)) or 25.0
        self._pos = 0
        self._short_edge = int(short_edge or 0)

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
        if self._short_edge:
            h, w = frame.shape[:2]
            nh, nw = short_edge_size(h, w, self._short_edge)
            if (nh, nw) != (h, w):
                frame = self._cv2.resize(frame, (nw, nh),
                                         interpolation=self._cv2.INTER_AREA)
        return frame[:, :, ::-1]  # BGR -> RGB

    def get_batch(self, indices):
        indices = np.asarray(indices, dtype=np.int64)
        frames = [None] * len(indices)
        for o in np.argsort(indices, kind="stable"):
            frames[o] = self._read_at(int(indices[o]))
        return np.ascontiguousarray(np.stack(frames))

    def close(self):
        self.cap.release()


class VideoReader:
    """A reader of ``path`` through ``backend`` (see the module's doc);
    ``.backend`` names the one it opened with. ``num_threads`` is the
    native decoder's codec threads (OpenCV sizes its own pool)."""

    def __init__(self, path, backend="auto", num_threads=1, short_edge=0):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        if backend == "auto":
            backend = auto_backend()[0]
        if backend == "native":
            self._impl = videodec.NativeVideoReader(
                path, num_threads=num_threads, short_edge=short_edge)
        else:
            self._impl = CV2Reader(path, short_edge=short_edge)
        self.backend = backend

    def __len__(self):
        return len(self._impl)

    @property
    def fps(self):
        return self._impl.fps

    def get_batch(self, indices):
        return self._impl.get_batch(indices)

    def close(self):
        self._impl.close()


class DecordInit:
    """The reference's decoder factory (dataset.py:96-119):
    ``DecordInit(num_threads)(path)`` opens a ``VideoReader`` with the
    default backend and those threads."""

    def __init__(self, num_threads=1, **kwargs):
        self.num_threads = num_threads
        self.kwargs = kwargs

    def __call__(self, filename):
        return VideoReader(filename, num_threads=self.num_threads)

    def __repr__(self):
        return f"{self.__class__.__name__}(num_threads={self.num_threads})"
