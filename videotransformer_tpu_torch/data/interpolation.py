"""Separable image resize as two weight products, with torch's kernels.

Port of ``videotransformer_tpu/data/interpolation.py``. The resize is
``F.interpolate``'s (no antialias, align_corners=False): a bicubic (Keys,
a = -0.75), bilinear or nearest weight matrix per axis, built on the host in
numpy (``resize_matrix``, a copy of the JAX package's), applied to a tensor
as ``W_h @ img @ W_w^T`` (``resize_hw``) on the tensor's device.
"""

import contextlib
import functools

import numpy as np
import torch


@contextlib.contextmanager
def exact_fp32(device):
    """fp32 products on ``device`` whatever the TF32 setting: on a CUDA
    device ``torch.matmul`` runs with TF32 off inside the block (the
    setting is restored after it); on the CPU there is no TF32."""
    if torch.device(device).type != "cuda":
        yield
        return
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    flags.allow_tf32 = False
    try:
        yield
    finally:
        flags.allow_tf32 = before


def _cubic_kernel(x, a=-0.75):
    x = np.abs(x)
    return np.where(
        x <= 1.0,
        (a + 2.0) * x**3 - (a + 3.0) * x**2 + 1.0,
        np.where(x < 2.0, a * x**3 - 5.0 * a * x**2 + 8.0 * a * x - 4.0 * a,
                 0.0))


def _linear_kernel(x):
    return np.clip(1.0 - np.abs(x), 0.0, None)


@functools.lru_cache(maxsize=256)
def resize_matrix(in_size: int, out_size: int, method: str = "bicubic"):
    """(out_size, in_size) float32 weights for one axis (interpolation.py:
    39-71): source taps clamp to the border, as torch's do."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    if method == "nearest":  # torch 'nearest': floor(dst * scale)
        idx = np.clip(np.floor(dst * scale).astype(np.int64), 0, in_size - 1)
        mat = np.zeros((out_size, in_size), dtype=np.float32)
        mat[np.arange(out_size), idx] = 1.0
        return mat
    kernels = {"bicubic": (_cubic_kernel, 2), "bilinear": (_linear_kernel, 1)}
    if method not in kernels:
        raise ValueError(method)
    kernel, support = kernels[method]
    src = (dst + 0.5) * scale - 0.5
    base = np.floor(src).astype(np.int64)
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for t in range(-support + 1, support + 1):
        idx = base + t
        np.add.at(mat, (np.arange(out_size), np.clip(idx, 0, in_size - 1)),
                  kernel(src - idx))
    return mat.astype(np.float32)


def resize_hw(img, out_h: int, out_w: int, method: str = "bicubic"):
    """Resize the last two axes of the tensor ``img`` (..., H, W) -> fp32
    (..., out_h, out_w), on ``img``'s device."""
    wh = torch.from_numpy(resize_matrix(img.shape[-2], out_h, method))
    ww = torch.from_numpy(resize_matrix(img.shape[-1], out_w, method))
    wh, ww = wh.to(img.device), ww.to(img.device)
    with exact_fp32(img.device):
        return torch.matmul(torch.matmul(wh, img.float()), ww.t())


def short_edge_size(h, w, short):
    """(out_h, out_w) of a short-edge resize to ``short`` (interpolation.py:
    90-101: the long edge is truncated, not rounded)."""
    if h <= w:
        return short, int(short * w / h)
    return int(short * h / w), short


def resize_short_edge(img, short: int, method: str = "bicubic"):
    """torchvision Resize(int) on a tensor (..., H, W): the short edge
    becomes ``short``; unchanged when it already is."""
    out = short_edge_size(img.shape[-2], img.shape[-1], short)
    if out == tuple(img.shape[-2:]):
        return img
    return resize_hw(img, *out, method)
