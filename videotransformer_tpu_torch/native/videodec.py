"""ctypes binding of the port's FFmpeg decoder (``videodec.cpp``).

Port of ``videotransformer_tpu/native/videodec.py``. ``videodec.cpp`` is
compiled by ``g++`` against the system's FFmpeg (libavformat, libavcodec,
libavutil, libswscale and their headers) into
``videotransformer_tpu_torch/build/libvideodec.so`` at its first use, under
a lock, and rebuilt when the source is newer than the library (the pattern
of ``kernels/_build.py``). A missing compiler or a failed build raises
``DecoderBuildError`` with the compiler's output; nothing falls back here
(``data/video_reader.py`` decides what ``backend="auto"`` does).

``NativeVideoReader`` has the decord-style API of the JAX package's:
``len()``, ``fps``, ``width``, ``height``, ``get_batch(indices)`` -> uint8
(N, H, W, C) RGB in request order, and ``close()``.
"""

import ctypes
import os
import shutil
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "videodec.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
LIB_NAME = "libvideodec.so"
CXX_FLAGS = ["-O2", "-shared", "-fPIC"]
FFMPEG_LIBS = ["-lavformat", "-lavcodec", "-lavutil", "-lswscale"]

_H = ctypes.c_void_p
# entry point: (restype, argtypes)
SIGNATURES = {
    "vd_open": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_int,
                                  ctypes.c_int]),
    "vd_num_frames": (ctypes.c_int64, [_H]),
    "vd_fps": (ctypes.c_double, [_H]),
    "vd_width": (ctypes.c_int, [_H]),
    "vd_height": (ctypes.c_int, [_H]),
    "vd_error": (ctypes.c_char_p, [_H]),
    "vd_get_batch": (ctypes.c_int, [_H, ctypes.POINTER(ctypes.c_int64),
                                    ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_uint8)]),
    "vd_close": (None, [_H]),
}

_lock = threading.Lock()
_libs = {}


class DecoderBuildError(RuntimeError):
    """The library could not be built; ``output`` is the compiler's."""

    def __init__(self, message, output=""):
        super().__init__(message + output)
        self.output = output


def compile_library(src, lib_name, build_dir, error):
    """Compile ``src`` with g++ against FFmpeg into ``<build_dir>/<lib_name>``
    unless it is up to date; returns the library's path. The library is
    written under a temporary name and renamed, so processes building at
    once each leave a whole library. A missing g++ or a failed build raises
    ``error`` (a class taking the message and the compiler's output)."""
    so = os.path.join(build_dir, lib_name)
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise error(
            f"g++ not found on PATH: {lib_name} is built from {src} at first "
            f"use and needs g++ and FFmpeg's headers")
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [cxx, *CXX_FLAGS, src, *FFMPEG_LIBS, "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise error(f"g++ failed ({proc.returncode}) building {lib_name}:\n"
                    f"{' '.join(cmd)}\n", proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


def build(build_dir=None):
    """Compile ``videodec.cpp`` into ``<build_dir>/libvideodec.so`` unless
    it is up to date; returns the library's path (``compile_library``)."""
    return compile_library(SRC, LIB_NAME, build_dir or BUILD_DIR,
                           DecoderBuildError)


def get_lib():
    """Build (if needed) and load the decoder library, once per build
    directory (``BUILD_DIR``) and process."""
    with _lock:
        lib = _libs.get(BUILD_DIR)
        if lib is None:
            lib = ctypes.CDLL(build(BUILD_DIR))
            for fn, (restype, argtypes) in SIGNATURES.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[BUILD_DIR] = lib
        return lib


class NativeVideoReader:
    def __init__(self, path, num_threads=1, short_edge=0):
        self._h = None
        self._lib = get_lib()
        self._h = self._lib.vd_open(path.encode(), int(num_threads),
                                    int(short_edge or 0))
        if not self._h:
            raise IOError(f"native decoder could not open {path}")
        self.path = path
        self.num_frames = int(self._lib.vd_num_frames(self._h))
        self.fps = float(self._lib.vd_fps(self._h))
        self.width = int(self._lib.vd_width(self._h))
        self.height = int(self._lib.vd_height(self._h))

    def __len__(self):
        return self.num_frames

    def get_batch(self, indices):
        """Frames at ``indices`` (any order, repeats allowed): the library
        decodes them in ascending order; the rows come back in request
        order."""
        indices = np.asarray(indices, dtype=np.int64)
        order = np.argsort(indices, kind="stable")
        sorted_idx = np.ascontiguousarray(indices[order])
        n = len(indices)
        out = np.empty((n, self.height, self.width, 3), dtype=np.uint8)
        ret = self._lib.vd_get_batch(
            self._h,
            sorted_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if ret != 0:
            err = self._lib.vd_error(self._h).decode()
            raise IOError(f"native decode failed ({ret}): {err} [{self.path}]")
        inv = np.empty_like(order)
        inv[order] = np.arange(n)
        return np.ascontiguousarray(out[inv])

    def close(self):
        if self._h:
            self._lib.vd_close(self._h)
            self._h = None

    def __del__(self):
        self.close()
