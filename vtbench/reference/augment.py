"""The train augment and the eval recipe of uint8 clips, plain, float32.

Follows ``data/device_augment.py`` of the port (itself the JAX package's
``device_augment.py:64-445``): torchvision's RandomResizedCrop with a
bicubic resize (Keys a = -0.75, taps clamped to the crop box), a
horizontal flip, ColorJitter (brightness, contrast, saturation in a drawn
order; no hue), ToTensor and Normalize; the eval recipe is Resize(short
256) and ThreeCrop (left, right, centre). The draws are made from a
``torch.Generator`` in the same calls and order as the program makes them
(``draw``), so the same seed gives the same boxes, flips and factors.
"""

import math

import numpy as np
import torch


# ------------------------------------------------------------------ draws

def draw_crop(g, n, height, width, scale, ratio, device):
    u = torch.rand((n, 22), generator=g, device=device)
    target = height * width * (scale[0] + (scale[1] - scale[0]) * u[:, :10])
    lo, hi = math.log(ratio[0]), math.log(ratio[1])
    aspect = torch.exp(lo + (hi - lo) * u[:, 10:20])
    w = torch.round(torch.sqrt(target * aspect))
    h = torch.round(torch.sqrt(target / aspect))
    valid = (w > 0) & (w <= width) & (h > 0) & (h <= height)
    rank = torch.arange(10, 0, -1, device=u.device)
    first = torch.argmax(valid.int() * rank, dim=1, keepdim=True)
    w, h = w.gather(1, first)[:, 0], h.gather(1, first)[:, 0]
    top = torch.floor(u[:, 20] * (height - h + 1))
    left = torch.floor(u[:, 21] * (width - w + 1))
    fb_w, fb_h = float(width), float(height)
    if width / height < ratio[0]:
        fb_h = float(np.round(np.float32(width / ratio[0])))
    elif width / height > ratio[1]:
        fb_w = float(np.round(np.float32(height * ratio[1])))
    ok = valid.any(1)
    fallback = ((height - fb_h) // 2, (width - fb_w) // 2, fb_h, fb_w)
    return torch.stack([torch.where(ok, v, f) for v, f in zip(
        (top, left, h, w), fallback)], dim=1)


def draw_jitter(g, n, color, device):
    u = torch.rand((n, 8), generator=g, device=device)
    factors = []
    for i, s in enumerate(color[:3]):
        if not s:
            factors.append(torch.ones(n, device=u.device))
        else:
            lo = max(0.0, 1 - s)
            factors.append(lo + (1 + s - lo) * u[:, i])
    return torch.stack(factors, dim=1), torch.argsort(u[:, 4:], dim=1)


def draw(g, shape, recipe, device):
    """The augment's draws for a batch of ``shape`` (B, T, H, W, C):
    {"box", "flip"[, "jitter_factors", "jitter_order"]}."""
    if recipe.get("auto_augment"):
        raise ValueError("RandAugment is not in the reference")
    if len(recipe["color"]) > 3 and recipe["color"][3]:
        raise ValueError("hue jitter is not in the reference")
    b, _, height, width, _ = shape
    out = {"box": draw_crop(g, b, height, width, tuple(recipe["scale"]),
                            (3 / 4, 4 / 3), device),
           "flip": torch.rand(b, generator=g, device=device)
           < recipe["hflip"]}
    if any(recipe["color"]):
        out["jitter_factors"], out["jitter_order"] = draw_jitter(
            g, b, recipe["color"], device)
    return out


def rows(draws, lo, hi):
    return {k: v[lo:hi] for k, v in draws.items()}


# ------------------------------------------------------------------ apply

def _cubic_weights(src, in_size, lo, hi, a=-0.75):
    base = torch.floor(src)
    idx = torch.arange(in_size, device=src.device)
    mat = torch.zeros(src.shape + (in_size,), device=src.device)
    for t in range(-1, 3):
        tap = base + t
        x = (src - tap).abs()
        w = torch.where(
            x <= 1.0, (a + 2.0) * x**3 - (a + 3.0) * x**2 + 1.0,
            torch.where(x < 2.0, a * x**3 - 5 * a * x**2 + 8 * a * x - 4 * a,
                        0.0))
        tap = torch.minimum(torch.maximum(tap, lo[:, None]), hi[:, None])
        mat = mat + w[..., None] * (idx == tap.long()[..., None])
    return mat


def crop_weights(start, extent, size, out_size):
    pos = torch.arange(out_size, device=start.device, dtype=torch.float32)
    src = start[:, None] + (pos + 0.5) * (extent / out_size)[:, None] - 0.5
    lo = torch.floor(start)
    return _cubic_weights(src, size, lo, lo + torch.floor(extent) - 1)


def _gray(x):
    return (0.2989 * x[..., 0] + 0.587 * x[..., 1]
            + 0.114 * x[..., 2])[..., None]


def _jitter(x, factors, order):
    per_clip = lambda v: v.view(-1, 1, 1, 1, 1)
    fb, fc, fs = (per_clip(f) for f in factors.unbind(1))
    ops = (
        lambda x: torch.clamp(x * fb, 0.0, 255.0),
        lambda x: torch.clamp(
            fc * x + (1 - fc) * _gray(x).mean(dim=(2, 3, 4), keepdim=True),
            0.0, 255.0),
        lambda x: torch.clamp(fs * x + (1 - fs) * _gray(x), 0.0, 255.0))
    for pos in range(4):
        k = per_clip(order[:, pos])
        out = x
        for op in (2, 1, 0):
            out = torch.where(k == op, ops[op](x), out)
        x = out
    return x


def normalize(x, mean, std):
    """[0, 255] (B, T, H, W, C) -> (B, T, C, H, W)."""
    return torch.stack([(x[..., c] / 255.0 - m) / s
                        for c, (m, s) in enumerate(zip(mean, std))], dim=2)


def augment(raw, draws, recipe, out_size, with_raw=False):
    """uint8 (B, T, H, W, C) -> normalised (B, T, C, S, S) fp32 (and the
    pixels before Normalize, (B, T, C, S, S), with ``with_raw``)."""
    x = raw.float()
    top, left, ch, cw = draws["box"].unbind(1)
    wh = crop_weights(top, ch, x.shape[2], out_size)
    ww = crop_weights(left, cw, x.shape[3], out_size)
    x = torch.einsum("boh,bthwc->btowc", wh, x)
    x = torch.einsum("bpw,btowc->btopc", ww, x)
    x = torch.where(draws["flip"].view(-1, 1, 1, 1, 1), x.flip(3), x)
    if "jitter_factors" in draws:
        x = _jitter(x, draws["jitter_factors"], draws["jitter_order"])
    norm = normalize(x, recipe["mean"], recipe["std"])
    if with_raw:
        return norm, x.permute(0, 1, 4, 2, 3)
    return norm


def three_crop(raw, img_size, mean, std):
    """The eval recipe: Resize(short 256) then ThreeCrop -> (B·3, T, C, S,
    S), each clip's three crops adjacent."""
    _, _, height, width, _ = raw.shape
    s = int(img_size)
    if height <= width:
        out_h, out_w = 256, int(256 * width / height)
    else:
        out_h, out_w = int(256 * height / width), 256
    x = raw.float()
    if (out_h, out_w) != (height, width):
        zero = torch.zeros(1, device=x.device)
        wh = crop_weights(zero, torch.full((1,), float(height),
                                           device=x.device), height, out_h)[0]
        ww = crop_weights(zero, torch.full((1,), float(width),
                                           device=x.device), width, out_w)[0]
        x = torch.einsum("oh,bthwc->btowc", wh, x)
        x = torch.einsum("pw,btowc->btopc", ww, x)
    y0 = (out_h - s) // 2
    xs = (0, out_w - s, (out_w - s) // 2)
    x = torch.stack([x[:, :, y0:y0 + s, x0:x0 + s] for x0 in xs], dim=1)
    return normalize(x.flatten(0, 1), mean, std)
