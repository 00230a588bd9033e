"""ctypes binding of the port's FFmpeg encoder (``videoenc.cpp``).

Port of ``videotransformer_tpu/native/videoenc.py``. ``videoenc.cpp`` is
compiled by ``g++`` against the system's FFmpeg (libavformat, libavcodec,
libavutil, libswscale and their headers) into
``videotransformer_tpu_torch/build/libvideoenc.so`` at its first use, under
a lock, and rebuilt when the source is newer than the library (the pattern
of ``videodec.py``). A missing compiler or a failed build raises
``EncoderBuildError`` with the compiler's output. The encoder is host-only:
no device path runs it, and a machine without FFmpeg's headers cannot
build it.

``write_video(path, frames, fps)`` encodes (T, H, W, 3) uint8 RGB frames to
an mp4 with the built-in MPEG-4 encoder (``tools/make_demo_assets.py``).
"""

import ctypes
import os
import threading

import numpy as np

from videotransformer_tpu_torch.native.videodec import (
    BUILD_DIR, compile_library)

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "videoenc.cpp")
LIB_NAME = "libvideoenc.so"

_lock = threading.Lock()
_libs = {}


class EncoderBuildError(RuntimeError):
    """The library could not be built; ``output`` is the compiler's."""

    def __init__(self, message, output=""):
        super().__init__(message + output)
        self.output = output


def build(build_dir=None):
    """Compile ``videoenc.cpp`` into ``<build_dir>/libvideoenc.so`` unless
    it is up to date; returns the library's path
    (``videodec.compile_library``)."""
    return compile_library(SRC, LIB_NAME, build_dir or BUILD_DIR,
                           EncoderBuildError)


def get_lib(build_dir=None):
    """Build (if needed) and load the encoder library, once per build
    directory and process."""
    build_dir = build_dir or BUILD_DIR
    with _lock:
        lib = _libs.get(build_dir)
        if lib is None:
            lib = ctypes.CDLL(build(build_dir))
            lib.venc_write.restype = ctypes.c_int
            lib.venc_write.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            _libs[build_dir] = lib
        return lib


def write_video(path, frames, fps=25):
    """Encode (T, H, W, 3) uint8 RGB frames, H and W even (yuv420p), to an
    mp4 at ``path``."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"frames must be (T, H, W, 3), got {frames.shape}")
    t, h, w, _ = frames.shape
    if h % 2 or w % 2:
        raise ValueError(f"yuv420p needs even dimensions, got {h}x{w}")
    rc = get_lib().venc_write(
        path.encode(), frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        t, h, w, int(fps))
    if rc != 0:
        raise RuntimeError(f"venc_write({path}) failed with code {rc}")
