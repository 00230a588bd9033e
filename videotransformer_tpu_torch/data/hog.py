"""HOG feature targets for MaskFeat, on the device.

Port of ``videotransformer_tpu/data/hog.py``: ``skimage.feature.hog`` with
the reference's parameters (orientations=9, pixels_per_cell=(8, 8),
cells_per_block=(1, 1), block_norm='L2', dataset.py:39-45), vectorised over
frames so it runs on the card inside the train step:

- gradients: central differences with zeroed borders;
- orientation = rad2deg(atan2(g_row, g_col)) mod 180, hard-binned into
  [20·i, 20·(i + 1)) (no interpolation);
- cell value = the MEAN magnitude over the 8x8 cell;
- L2 normalisation with eps 1e-5: cell / sqrt(sum(cell²) + eps²).

Per 224x224 RGB frame the output is (14, 14, 108): each 2x2 neighbourhood of
cells flattened as (dh, dw, [r9, g9, b9]). ``extract_hog_features_np`` is a
numpy copy of the JAX package's host version, the tests' reference.
"""

import numpy as np
import torch


def _hog_cells(img, orientations=9, cell=8):
    """img (N, H, W) float32 -> (N, H/cell, W/cell, orientations)."""
    g_row = torch.zeros_like(img)
    g_col = torch.zeros_like(img)
    g_row[:, 1:-1, :] = img[:, 2:, :] - img[:, :-2, :]
    g_col[:, :, 1:-1] = img[:, :, 2:] - img[:, :, :-2]
    mag = torch.sqrt(g_row ** 2 + g_col ** 2)
    ori = torch.rad2deg(torch.atan2(g_row, g_col)) % 180.0
    bins = torch.clamp((ori / (180.0 / orientations)).to(torch.int64),
                       max=orientations - 1)
    onehot = torch.nn.functional.one_hot(bins, orientations).to(img.dtype)
    onehot = onehot * mag[..., None]
    n, h, w = img.shape
    ch, cw = h // cell, w // cell
    cells = onehot[:, :ch * cell, :cw * cell].reshape(
        n, ch, cell, cw, cell, orientations)
    cells = cells.sum(dim=(2, 4)) / (cell * cell)
    eps = 1e-5
    return cells / torch.sqrt((cells ** 2).sum(-1, keepdim=True) + eps ** 2)


def batched_hog_targets(video, orientations=9, cell=8):
    """video (..., H, W, 3) -> (..., H/(2·cell), W/(2·cell), 12·orientations)
    in fp32, the un-normalised clip's HOG (the reference computes HOG before
    Normalize, data_trainer.py:61-66)."""
    lead = video.shape[:-3]
    h, w = video.shape[-3], video.shape[-2]
    frames = video.reshape(-1, h, w, 3).float()
    n = frames.shape[0]
    cells = _hog_cells(frames.permute(0, 3, 1, 2).reshape(n * 3, h, w),
                       orientations, cell)
    _, ch, cw, o = cells.shape
    # (n, 3, ch, cw, o) -> (n, ch, cw, 3·o), then 2x2 cells per token
    cells = cells.reshape(n, 3, ch, cw, o).permute(0, 2, 3, 1, 4).reshape(
        n, ch, cw, 3 * o)
    out = cells.reshape(n, ch // 2, 2, cw // 2, 2, 3 * o).permute(
        0, 1, 3, 2, 4, 5)
    return out.reshape(*lead, ch // 2, cw // 2, 4 * 3 * o)


def extract_hog_features(image, orientations=9, cell=8):
    """image (H, W, 3) -> (H/(2·cell), W/(2·cell), 12·orientations)."""
    return batched_hog_targets(image[None], orientations, cell)[0]


def _hog_cells_np(img, orientations=9, cell=8):
    img = np.asarray(img, dtype=np.float64)
    g_row = np.zeros_like(img)
    g_col = np.zeros_like(img)
    g_row[1:-1, :] = img[2:, :] - img[:-2, :]
    g_col[:, 1:-1] = img[:, 2:] - img[:, :-2]
    mag = np.hypot(g_row, g_col)
    ori = np.rad2deg(np.arctan2(g_row, g_col)) % 180
    bins = np.minimum((ori / (180 / orientations)).astype(np.int64),
                      orientations - 1)
    h, w = img.shape
    ch, cw = h // cell, w // cell
    onehot = np.eye(orientations)[bins] * mag[..., None]
    cells = onehot[:ch * cell, :cw * cell].reshape(ch, cell, cw, cell,
                                                   orientations)
    cells = cells.sum(axis=(1, 3)) / (cell * cell)
    eps = 1e-5
    norm = np.sqrt(np.sum(cells ** 2, axis=-1, keepdims=True) + eps ** 2)
    return cells / norm


def extract_hog_features_np(image, orientations=9, cell=8):
    """image (H, W, 3) -> (H/16, W/16, 108) in float64 math on the host."""
    per_ch = [_hog_cells_np(image[:, :, c], orientations, cell)
              for c in range(3)]
    cells = np.concatenate(per_ch, axis=-1)
    ch, cw, f = cells.shape
    out = cells.reshape(ch // 2, 2, cw // 2, 2, f).transpose(0, 2, 1, 3, 4)
    return out.reshape(ch // 2, cw // 2, 2 * 2 * f).astype(np.float32)
