"""HOG targets for MaskFeat, plain.

``skimage.feature.hog`` with the original repo's parameters (9
orientations, 8x8 pixel cells, 1x1 cell blocks, L2 block norm), as the
port's ``data/hog.py`` vectorises it: central differences with zeroed
borders, hard orientation bins of 20 degrees over [0, 180), the mean
magnitude of each cell, L2 normalisation with eps 1e-5; each 2x2
neighbourhood of cells flattened as (dh, dw, [r9, g9, b9]) -> 108
features per 16x16 pixels. ``cube_targets`` scatters the HOG of each
cube's center frame (2·start + span) into (B, T, h, w, 108), as the
trainer does (the original repo's trainer.py:353-372)."""

import torch


def _cells(img, orientations=9, cell=8):
    g_row = torch.zeros_like(img)
    g_col = torch.zeros_like(img)
    g_row[:, 1:-1, :] = img[:, 2:, :] - img[:, :-2, :]
    g_col[:, :, 1:-1] = img[:, :, 2:] - img[:, :, :-2]
    mag = torch.sqrt(g_row ** 2 + g_col ** 2)
    ori = torch.rad2deg(torch.atan2(g_row, g_col)) % 180.0
    bins = torch.clamp((ori / (180.0 / orientations)).to(torch.int64),
                       max=orientations - 1)
    onehot = torch.nn.functional.one_hot(bins, orientations).float()
    onehot = onehot * mag[..., None]
    n, h, w = img.shape
    ch, cw = h // cell, w // cell
    cells = onehot[:, :ch * cell, :cw * cell].reshape(
        n, ch, cell, cw, cell, orientations).sum(dim=(2, 4)) / (cell * cell)
    return cells / torch.sqrt((cells ** 2).sum(-1, keepdim=True) + 1e-10)


def hog(frames):
    """frames (N, H, W, 3) in [0, 255] -> (N, H/16, W/16, 108)."""
    n, h, w, _ = frames.shape
    cells = _cells(frames.permute(0, 3, 1, 2).reshape(n * 3, h, w).float())
    _, ch, cw, o = cells.shape
    cells = cells.reshape(n, 3, ch, cw, o).permute(0, 2, 3, 1, 4).reshape(
        n, ch, cw, 3 * o)
    out = cells.reshape(n, ch // 2, 2, cw // 2, 2, 3 * o).permute(
        0, 1, 3, 2, 4, 5)
    return out.reshape(n, ch // 2, cw // 2, 12 * o)


def cube_targets(raw, markers, counts):
    """raw (B, T, C, H, W) pixels before Normalize, markers (B, M, 2),
    counts (B,) -> (B, T, h, w, 108)."""
    frames = raw.permute(0, 1, 3, 4, 2)
    B, T = frames.shape[:2]
    centers = (markers[..., 0] * 2 + markers[..., 1]).long()
    valid = (torch.arange(markers.shape[1], device=raw.device)[None]
             < counts[:, None]).float()
    picked = frames[torch.arange(B, device=raw.device)[:, None], centers]
    h = hog(picked.reshape(-1, *picked.shape[2:])).reshape(
        B, markers.shape[1], *[s // 16 for s in picked.shape[2:4]], -1)
    onehot = (centers[..., None] == torch.arange(T, device=raw.device)
              ).float() * valid[..., None]
    return torch.einsum("bmt,bmhwc->bthwc", onehot, h)
