"""Train augmentation and eval preprocessing of uint8 clips on the device.

Port of ``videotransformer_tpu/data/device_augment.py``. The train augment
of a batch of canonical uint8 clips (B, T, H, W, C) is clip-consistent (one
draw applies to every frame of a clip): torchvision's RandomResizedCrop
(bicubic), a horizontal flip, then either ColorJitter (torchvision
semantics: one factor draw per clip, the four ops in a random order) or
RandAugment (two of 14 ops, magnitude 9 of 31), then ToTensor and Normalize.
``eval_preprocess_batch`` is the eval recipe: Resize, then CenterCrop or
ThreeCrop, then Normalize.

The draw is split from the apply. ``draw_augment`` (``draw_crop``,
``draw_flip``, ``draw_jitter``, ``draw_rand_augment``) takes a
``torch.Generator`` on the batch's device and returns the parameters as
tensors: the crop box, the flip, the jitter factors and order, the
RandAugment op ids and signs. ``augment_batch`` applies given draws, or
draws them. A caller can hand in draws made elsewhere: the tests feed the
port the draws that the JAX package's key chain makes.

Everything is batched over the clips and nothing synchronises with the
host: no value comes back, and no constant goes to the device by a copy
(a copy from pageable host memory can wait for the stream), so the
weights are built on the device and the constants are scalars. The JAX
package's ``vmap`` over ``lax.switch`` computes every branch
and selects, and so does this module, with ``torch.where`` per clip. The
crop's bicubic resize is two products with per-clip weight matrices (B, S,
H) and (B, S, W) built on the device from the drawn box, as in the JAX
package (device_augment.py:28-61, outside any Pallas kernel). All
arithmetic is fp32, with TF32 off for the products (``exact_fp32``).
"""

import math

import numpy as np
import torch

from videotransformer_tpu_torch.data.interpolation import (
    exact_fp32, short_edge_size)

RA_OPS = ("Identity", "ShearX", "ShearY", "TranslateX", "TranslateY",
          "Rotate", "Brightness", "Color", "Contrast", "Sharpness",
          "Posterize", "Solarize", "AutoContrast", "Equalize")
_GEOMETRIC, _BLEND = 5, 9  # ops 0-5 are one affine warp, 6-9 one blend


def _per_clip(v):
    """(B,) -> (B, 1, 1, 1, 1), to broadcast over (B, T, H, W, C)."""
    return v.view(-1, 1, 1, 1, 1)


# ------------------------------------------------------------------ draws

def draw_crop(generator, n, height, width, scale=(0.08, 1.0),
              ratio=(3 / 4, 4 / 3), device=None):
    """torchvision RandomResizedCrop's box for ``n`` clips of (height,
    width), as (n, 4) fp32 [top, left, h, w] (device_augment.py:64-100): 10
    candidates of uniform area share and log-uniform aspect, the first that
    fits wins; none fits -> the centre crop at the clamped aspect."""
    u = torch.rand((n, 22), generator=generator, device=device)
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
    in_ratio = width / height
    fb_w, fb_h = float(width), float(height)
    if in_ratio < ratio[0]:
        fb_h = float(np.round(np.float32(width / ratio[0])))
    elif in_ratio > ratio[1]:
        fb_w = float(np.round(np.float32(height * ratio[1])))
    ok = valid.any(1)
    fallback = ((height - fb_h) // 2, (width - fb_w) // 2, fb_h, fb_w)
    return torch.stack([torch.where(ok, v, f) for v, f in zip(
        (top, left, h, w), fallback)], dim=1)


def draw_flip(generator, n, p=0.5, device=None):
    """(n,) bool: flip each clip with probability ``p``."""
    return torch.rand(n, generator=generator, device=device) < p


def draw_jitter(generator, n, color, device=None):
    """ColorJitter's draw for ``n`` clips, ``color`` = (brightness,
    contrast, saturation, hue) strengths: (n, 4) fp32 factors (uniform in
    [max(0, 1 - s), 1 + s] for the first three, [-hue, hue] for the hue
    shift; 1, 1, 1, 0 where a strength is 0) and (n, 4) the order of the
    four ops (a uniform permutation per clip)."""
    u = torch.rand((n, 8), generator=generator, device=device)
    factors = []
    for i, s in enumerate(color):
        if not s:
            factors.append(torch.full((n,), 0.0 if i == 3 else 1.0,
                                      device=u.device))
        elif i == 3:
            factors.append(-s + 2 * s * u[:, i])
        else:
            lo = max(0.0, 1 - s)
            factors.append(lo + (1 + s - lo) * u[:, i])
    return torch.stack(factors, dim=1), torch.argsort(u[:, 4:], dim=1)


def draw_rand_augment(generator, n, num_ops=2, device=None):
    """RandAugment's draw for ``n`` clips: (n, num_ops) op ids in
    ``RA_OPS`` (uniform) and (n, num_ops) fp32 signs (+-1, even odds)."""
    ops = torch.randint(0, len(RA_OPS), (n, num_ops), generator=generator,
                        device=device)
    u = torch.rand((n, num_ops), generator=generator, device=device)
    return ops, torch.where(u > 0.5, -1.0, 1.0)


def draw_augment(generator, shape, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 hflip=0.5, color=(0.4, 0.4, 0.4, 0.0), auto_augment=False,
                 num_ops=2, device=None):
    """Every draw of ``augment_batch`` for a batch of ``shape`` (B, T, H, W,
    C): {"box", "flip"} and {"jitter_factors", "jitter_order"} (ColorJitter)
    or {"ra_ops", "ra_signs"} (RandAugment)."""
    b, _, height, width, _ = shape
    draws = {"box": draw_crop(generator, b, height, width, scale, ratio,
                              device),
             "flip": draw_flip(generator, b, hflip, device)}
    if auto_augment:
        draws["ra_ops"], draws["ra_signs"] = draw_rand_augment(
            generator, b, num_ops, device)
    elif any(color):
        draws["jitter_factors"], draws["jitter_order"] = draw_jitter(
            generator, b, color, device)
    return draws


# ------------------------------------------------------------------ crop

def _cubic_weights(src, in_size, lo, hi, a=-0.75):
    """(B, out, in) Keys-cubic weights for the source coordinates src (B,
    out); taps clamp to [lo, hi] (B,), the crop box, so its border
    replicates as torchvision's crop-then-resize does."""
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
    """The (B, out_size, size) weights of one axis of length ``size`` for
    crops from ``start`` (B,) of ``extent`` (B,) pixels."""
    pos = torch.arange(out_size, device=start.device, dtype=torch.float32)
    src = start[:, None] + (pos + 0.5) * (extent / out_size)[:, None] - 0.5
    lo = torch.floor(start)
    return _cubic_weights(src, size, lo, lo + torch.floor(extent) - 1)


def resized_crop(clips, box, out_h, out_w):
    """clips (B, T, H, W, C) fp32, boxes (B, 4) [top, left, h, w] -> the
    bicubic resize of each clip's box to (out_h, out_w)."""
    top, left, crop_h, crop_w = box.unbind(1)
    wh = crop_weights(top, crop_h, clips.shape[2], out_h)
    ww = crop_weights(left, crop_w, clips.shape[3], out_w)
    with exact_fp32(clips.device):
        out = torch.einsum("boh,bthwc->btowc", wh, clips)
        return torch.einsum("bpw,btowc->btopc", ww, out)


# ------------------------------------------------------------------ colour

def _gray(x):
    """(..., C) -> (..., 1), ITU-R 601-2."""
    return (0.2989 * x[..., 0] + 0.587 * x[..., 1]
            + 0.114 * x[..., 2])[..., None]


def _frame_mean_gray(x):
    """Each frame's mean gray level, (B, T, 1, 1, 1)."""
    return _gray(x).mean(dim=(2, 3, 4), keepdim=True)


def _hue_shift(x, fh):
    """torchvision's adjust_hue of x (..., 3) in [0, 255] by fh (per clip,
    broadcastable): to HSV, shift, back (device_augment.py:129-161)."""
    s = x / 255.0
    r, g, b = s.unbind(-1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    eqc = maxc == minc
    cr = maxc - minc
    ones = torch.ones_like(maxc)
    sat = cr / torch.where(eqc, ones, maxc)
    cr_div = torch.where(eqc, ones, cr)
    rc, gc, bc = (maxc - r) / cr_div, (maxc - g) / cr_div, (maxc - b) / cr_div
    hh = ((maxc == r) * (bc - gc)
          + ((maxc == g) & (maxc != r)) * (2.0 + rc - bc)
          + ((maxc != g) & (maxc != r)) * (4.0 + gc - rc))
    hh = (hh / 6.0 + 1.0) % 1.0
    hh = (hh + fh[..., 0]) % 1.0
    i = torch.floor(hh * 6.0)
    f = hh * 6.0 - i
    i = i.long() % 6
    p = torch.clamp(maxc * (1.0 - sat), 0.0, 1.0)
    q = torch.clamp(maxc * (1.0 - sat * f), 0.0, 1.0)
    t = torch.clamp(maxc * (1.0 - sat * (1.0 - f)), 0.0, 1.0)
    table = ((maxc, q, p, p, t, maxc), (t, maxc, maxc, q, p, p),
             (p, p, t, maxc, maxc, q))
    rgb = [torch.stack(row, -1).gather(-1, i[..., None])[..., 0]
           for row in table]
    return torch.stack(rgb, -1) * 255.0


def color_jitter(clips, factors, order, color):
    """clips (B, T, S, S, C) in [0, 255]; ``factors`` (B, 4) and ``order``
    (B, 4) from ``draw_jitter``; ``color`` the strengths (device_augment.py:
    108-169). Every op runs on every clip at each of the four positions and
    each clip takes the op of its order there."""
    fb, fc, fs, fh = (_per_clip(f) for f in factors.unbind(1))
    ops = (
        lambda x: torch.clamp(x * fb, 0.0, 255.0),
        lambda x: torch.clamp(fc * x + (1 - fc) * _frame_mean_gray(x),
                              0.0, 255.0),
        lambda x: torch.clamp(fs * x + (1 - fs) * _gray(x), 0.0, 255.0),
        (lambda x: _hue_shift(x, fh)) if color[3] else (lambda x: x))
    x = clips
    for pos in range(4):
        k = _per_clip(order[:, pos])
        out = ops[3](x)
        for op in (2, 1, 0):
            out = torch.where(k == op, ops[op](x), out)
        x = out
    return x


# ------------------------------------------------------------------ RandAugment

def ra_magnitudes(magnitude=9, bins=31):
    """Each op's magnitude at index ``magnitude`` of ``bins`` (the host
    RandAugment's _space; device_augment.py:295-307)."""
    lin = lambda a, b: float(np.linspace(a, b, bins)[magnitude])
    return {"shear": lin(0.0, 0.3), "translate": lin(0.0, 150.0 / 331.0),
            "rotate": lin(0.0, 30.0), "photo": lin(0.0, 0.9),
            "posterize": int(8 - round(magnitude / ((bins - 1) / 4))),
            "solarize": lin(255.0, 0.0)}


def _affine_matrix(op, sign, m, height, width):
    """The forward 2x3 matrix of each clip's geometric op, (B,) entries
    a, b, c, d, e, f: ShearX, ShearY (about the centre), TranslateX,
    TranslateY (truncated to whole pixels), Rotate (about the centre), the
    identity for every other op (device_augment.py:198-217)."""
    cx, cy = width * 0.5, height * 0.5
    one, zero = torch.ones_like(sign), torch.zeros_like(sign)
    shear = sign * m["shear"]
    tx = torch.trunc(sign * m["translate"] * width)
    ty = torch.trunc(sign * m["translate"] * height)
    rad = sign * m["rotate"] * (math.pi / 180.0)
    al, be = torch.cos(rad), torch.sin(rad)
    cases = (  # op: (a, b, c, d, e, f)
        (1, (one, shear, -shear * cy, zero, one, zero)),
        (2, (one, zero, zero, shear, one, -shear * cx)),
        (3, (one, zero, tx, zero, one, zero)),
        (4, (one, zero, zero, zero, one, ty)),
        (5, (al, be, (1.0 - al) * cx - be * cy, -be, al,
             be * cx + (1.0 - al) * cy)))
    mat = (one, zero, zero, zero, one, zero)
    for k, entries in cases:
        mat = tuple(torch.where(op == k, v, w) for v, w in zip(entries, mat))
    return mat


def affine_nearest(clips, mat):
    """Nearest-neighbour warp of clips (B, T, H, W, C) by each clip's
    forward matrix (a, b, c, d, e, f), cv2.warpAffine's semantics: the
    matrix inverted, nearest = floor(src + 0.5), fill 0
    (device_augment.py:179-195)."""
    b_, t_, height, width, c_ = clips.shape
    a, b, c, d, e, f = (v.view(-1, 1, 1) for v in mat)
    dev = clips.device
    y, x = torch.meshgrid(torch.arange(height, device=dev, dtype=torch.float32),
                          torch.arange(width, device=dev, dtype=torch.float32),
                          indexing="ij")
    det = a * e - b * d
    sx = (e * (x - c) - b * (y - f)) / det
    sy = (-d * (x - c) + a * (y - f)) / det
    xi = torch.floor(sx + 0.5).long()
    yi = torch.floor(sy + 0.5).long()
    valid = (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
    src = yi.clamp(0, height - 1) * width + xi.clamp(0, width - 1)
    src = src.view(b_, 1, height * width, 1).expand(b_, t_, -1, c_)
    out = clips.reshape(b_, t_, height * width, c_).gather(2, src)
    out = out.view(clips.shape)
    return torch.where(valid[:, None, :, :, None], out, 0.0)


def _smooth(x):
    """PIL's SMOOTH filter ([[1, 1, 1], [1, 5, 1], [1, 1, 1]] / 13) on each
    frame and channel of x (B, T, H, W, C), with the 1-pixel border left as
    it is (device_augment.py:235-249), as nine shifted products."""
    height, width = x.shape[2], x.shape[3]
    k1, k5 = np.float32(1) / np.float32(13), np.float32(5) / np.float32(13)
    inner = 0.0
    for i in range(3):
        for j in range(3):
            w = float(k5 if (i, j) == (1, 1) else k1)
            inner = inner + w * x[:, :, i:i + height - 2, j:j + width - 2]
    out = x.clone()
    out[:, :, 1:-1, 1:-1] = inner
    return out


def _to_uint8(x):
    """float -> uint8 as the JAX package converts: saturating, truncated."""
    return torch.clamp(x, 0.0, 255.0).to(torch.uint8)


def _autocontrast(x):
    """Per frame and channel: stretch [min, max] to [0, 255]."""
    lo = x.amin(dim=(2, 3), keepdim=True)
    hi = x.amax(dim=(2, 3), keepdim=True)
    scale = torch.where(hi > lo, 255.0 / torch.clamp(hi - lo, min=1e-6), 1.0)
    return torch.clamp(torch.where(hi > lo, (x - lo) * scale, x), 0.0, 255.0)


def _equalize(x):
    """cv2.equalizeHist per frame and channel (device_augment.py:270-292):
    lut[i] = round((cdf[i] - cdf[first]) · 255 / (total - hist[first])),
    the identity where one gray level fills the image. The histograms are
    one scatter-add over all frames and channels."""
    b_, t_, height, width, c_ = x.shape
    total = height * width
    flat = _to_uint8(x).permute(0, 1, 4, 2, 3).reshape(-1, total).long()
    hist = torch.zeros(flat.shape[0], 256, dtype=torch.int64,
                       device=x.device)
    hist.scatter_add_(1, flat, torch.ones_like(flat))
    first = torch.argmax((hist > 0).int(), dim=1, keepdim=True)
    hf = hist.gather(1, first)
    scale = 255.0 / torch.clamp(total - hf, min=1).float()
    cdf = hist.cumsum(1)
    lut = torch.clamp(torch.round((cdf - cdf.gather(1, first)).float()
                                  * scale), 0.0, 255.0)
    identity = torch.arange(256, device=x.device, dtype=torch.float32)
    lut = torch.where(hf == total, identity, lut)
    out = lut.gather(1, flat).view(b_, t_, c_, height, width)
    return out.permute(0, 1, 3, 4, 2)


def rand_augment_step(clips, op, sign, m):
    """One RandAugment draw: each clip (B, T, S, S, C) in [0, 255] takes
    op ``op`` (B,) of ``RA_OPS`` with sign ``sign`` (B,) at magnitudes
    ``m`` (``ra_magnitudes``; device_augment.py:318-340). The geometric ops
    (and the identity) are one warp by a per-clip matrix; Brightness,
    Color, Contrast and Sharpness are one blend a·x + b·y with per-clip
    a, b and y (0, gray, frame mean, smoothed)."""
    height, width = clips.shape[2], clips.shape[3]
    geo = affine_nearest(clips, _affine_matrix(op, sign, m, height, width))
    mag = sign * m["photo"]
    a = 1.0 + mag
    b = torch.where(op == 9, 1.0 - a, -mag)
    op5 = _per_clip(op)
    y = torch.where(op5 == 7, _gray(clips),
                    torch.where(op5 == 8, _frame_mean_gray(clips),
                                torch.where(op5 == 9, _smooth(clips), 0.0)))
    blend = torch.clamp(_per_clip(a) * clips + _per_clip(b) * y, 0.0, 255.0)
    mask = 255 - (2 ** (8 - m["posterize"]) - 1)
    others = (  # op: result
        (10, (_to_uint8(clips) & mask).float()),
        (11, torch.where(clips >= m["solarize"], 255.0 - clips, clips)),
        (12, _autocontrast(clips)))
    out = _equalize(clips)
    for k, v in reversed(others):
        out = torch.where(op5 == k, v, out)
    out = torch.where(op5 <= _BLEND, blend, out)
    return torch.where(op5 <= _GEOMETRIC, geo, out)


def rand_augment(clips, ops, signs, magnitude=9, bins=31):
    """RandAugment on clips (B, T, S, S, C) in [0, 255] with the draws
    ``ops``, ``signs`` (B, num_ops) of ``draw_rand_augment``."""
    m = ra_magnitudes(magnitude, bins)
    for j in range(ops.shape[1]):
        clips = rand_augment_step(clips, ops[:, j], signs[:, j], m)
    return clips


# ------------------------------------------------------------------ recipes

def _normalize(x, mean, std):
    """[0, 255] (B, T, H, W, C) -> ToTensor + Normalize, (B, T, C, H, W)."""
    return torch.stack([(x[..., c] / 255.0 - m) / s
                        for c, (m, s) in enumerate(zip(mean, std))], dim=2)


def augment_batch(batch, out_size=224, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                  hflip=0.5, color=(0.4, 0.4, 0.4, 0.0), auto_augment=False,
                  mean=(0.45, 0.45, 0.45), std=(0.225, 0.225, 0.225),
                  with_raw=False, generator=None, draws=None):
    """batch (B, T, H, W, C) uint8 -> (B, T, C, S, S) fp32, the train
    augment of each clip (device_augment.py:344-396). ``draws`` as
    ``draw_augment`` returns them, else drawn from ``generator`` (a
    ``torch.Generator`` on the batch's device; None: the device's default).
    ``auto_augment`` runs RandAugment in place of ColorJitter.
    ``with_raw`` also returns the clips before ToTensor + Normalize, (B, T,
    C, S, S) in [0, 255]: the pixels MaskFeat's HOG targets read."""
    if draws is None:
        draws = draw_augment(generator, batch.shape, scale, ratio, hflip,
                             color, auto_augment, device=batch.device)
    out = resized_crop(batch.float(), draws["box"], out_size, out_size)
    out = torch.where(_per_clip(draws["flip"]), out.flip(3), out)
    if auto_augment:
        out = rand_augment(out, draws["ra_ops"], draws["ra_signs"])
    elif any(color):
        out = color_jitter(out, draws["jitter_factors"],
                           draws["jitter_order"], color)
    norm = _normalize(out, mean, std)
    if with_raw:
        return norm, out.permute(0, 1, 4, 2, 3).contiguous()
    return norm


def eval_preprocess_batch(batch, img_size=224, crop_pct=0.875,
                          three_crop=False, mean=(0.45, 0.45, 0.45),
                          std=(0.225, 0.225, 0.225)):
    """The eval recipe of canonical uint8 clips (B, T, H, W, C)
    (device_augment.py:399-445): val = Resize(short = floor(img_size /
    crop_pct)) + CenterCrop (offsets rounded); test = Resize(short 256) +
    ThreeCrop (left, right, centre; offsets floored), laid out (B·3, T, C,
    S, S) with each clip's crops adjacent; then ToTensor + Normalize. The
    resize is bicubic (the JAX package's default, the only one its callers
    use): two products with the weights of a crop of the whole clip (those
    of ``data/interpolation.py::resize_matrix``, built on the device)."""
    _, _, height, width, _ = batch.shape
    s = int(img_size)
    short = 256 if three_crop else int(math.floor(s / crop_pct))
    out_h, out_w = short_edge_size(height, width, short)
    x = batch.float()
    if (out_h, out_w) != (height, width):
        whole = lambda n: (torch.zeros(1, device=x.device),
                           torch.full((1,), float(n), device=x.device))
        wh = crop_weights(*whole(height), height, out_h)[0]
        ww = crop_weights(*whole(width), width, out_w)[0]
        with exact_fp32(x.device):
            x = torch.einsum("oh,bthwc->btowc", wh, x)
            x = torch.einsum("pw,btowc->btopc", ww, x)
    if three_crop:
        y0 = (out_h - s) // 2
        xs = (0, out_w - s, (out_w - s) // 2)
        x = torch.stack([x[:, :, y0:y0 + s, x0:x0 + s] for x0 in xs], dim=1)
        x = x.flatten(0, 1)
    else:
        y0 = int(round((out_h - s) / 2.0))
        x0 = int(round((out_w - s) / 2.0))
        x = x[:, :, y0:y0 + s, x0:x0 + s]
    return _normalize(x, mean, std)
