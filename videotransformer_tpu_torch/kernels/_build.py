"""Build, load and call the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into
``videotransformer_tpu_torch/build/lib<name>.so`` at its first use, under a
lock, and rebuilt when any source in ``csrc/`` is newer than the library
(the pattern of ``videotransformer_tpu/native/videodec.py``). The library
has a plain C interface and is bound with ``ctypes``: every pointer and the
stream are ``c_void_p``, every int ``c_int``, every float ``c_float``. Each
entry point returns the ``cudaGetLastError()`` code of its launches, and
``check_status`` raises when it is not 0.

Nothing here falls back: a missing ``nvcc`` or a failed build raises with the
compiler's output.
"""

import ctypes
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs = {}


class KernelBuildError(RuntimeError):
    pass


def find_nvcc():
    """Path of ``nvcc``: ``$CUDA_HOME/bin/nvcc`` (default /usr/local/cuda),
    else the first on ``PATH``. Raises KernelBuildError when there is none."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    found = shutil.which("nvcc")
    if found:
        return found
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the port's "
        "CUDA kernels are built from csrc/ at first use and need the CUDA "
        "toolkit")


def _sources_mtime(csrc):
    return max(os.path.getmtime(os.path.join(csrc, f))
               for f in os.listdir(csrc) if f.endswith((".cu", ".cuh")))


def build(name, build_dir=None, csrc=None):
    """Compile ``csrc/<name>.cu`` into ``lib<name>.so`` unless it is up to
    date; returns the library path. The ``-Xptxas -v`` report goes to
    ``<name>.log`` beside it (see ``build_log``). ``csrc`` names another
    source directory (another checkout's, to compare kernels)."""
    build_dir = build_dir or BUILD_DIR
    csrc = csrc or CSRC
    so = os.path.join(build_dir, f"lib{name}.so")
    if os.path.exists(so) and os.path.getmtime(so) >= _sources_mtime(csrc):
        return so
    nvcc = find_nvcc()
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-I", csrc, "-o", tmp,
           os.path.join(csrc, f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}) building {name}:\n"
            f"{' '.join(cmd)}\n{log}")
    with open(os.path.join(build_dir, f"{name}.log"), "w") as f:
        f.write(log)
    os.replace(tmp, so)
    return so


def build_log(name, build_dir=None):
    """The compiler's ``-Xptxas -v`` report of the last build of ``name``."""
    with open(os.path.join(build_dir or BUILD_DIR, f"{name}.log")) as f:
        return f.read()


def load(name, signatures, csrc=None, build_dir=None):
    """Build (if needed) and load ``lib<name>.so``; ``signatures`` maps each
    C entry point to its ctypes argtypes. Every entry returns c_int.
    ``csrc`` and ``build_dir`` as in ``build``."""
    key = (name, csrc or CSRC)
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            lib = ctypes.CDLL(build(name, build_dir, csrc))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[key] = lib
        return lib


def check_status(name, status):
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")


def check_operands(name, **tensors):
    """The kernels take contiguous bf16 CUDA tensors on one device, with
    16-byte aligned storage (TMA and the kernels' loads move 16 bytes at a
    time)."""
    device = None
    for arg, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, expected cuda")
        device = device or t.device
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {arg} is {t.dtype}, expected bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} is not 16-byte aligned")


def stream_handle():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())
