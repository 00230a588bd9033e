"""RandAugment of video clips on the host (clip-consistent).

Port of ``videotransformer_tpu/data/rand_augment.py``: torchvision's policy
(num_ops 2, magnitude 9 of 31 bins, the 14-op space), which the reference
enables with ``-auto_augment`` (data_transform.py:518-529). The ops and
magnitudes are drawn once per clip (``randomize_parameters``, from
``transforms``' generator) and apply to every frame. Geometric ops are
cv2.warpAffine with nearest sampling and fill 0. ``cv2`` is imported where
an op needs it.
"""

import numpy as np

from videotransformer_tpu_torch.data import transforms as T


def _affine_clip(imgs, matrix):
    """Apply a 2x3 affine to every frame. imgs (T, C, H, W) float32, fill=0."""
    import cv2

    t, c, h, w = imgs.shape
    out = np.empty_like(imgs)
    flat = imgs.transpose(0, 2, 3, 1)  # T H W C
    for i in range(t):
        out_i = cv2.warpAffine(
            flat[i], matrix, (w, h), flags=cv2.INTER_NEAREST,
            borderMode=cv2.BORDER_CONSTANT, borderValue=0,
        )
        out[i] = out_i.transpose(2, 0, 1)
    return out


def _shear(imgs, sx=0.0, sy=0.0):
    h, w = imgs.shape[-2:]
    # torchvision shears about the image center
    cx, cy = w * 0.5, h * 0.5
    m = np.array([[1, sx, -sx * cy], [sy, 1, -sy * cx]], dtype=np.float32)
    return _affine_clip(imgs, m)


def _translate(imgs, tx=0, ty=0):
    m = np.array([[1, 0, tx], [0, 1, ty]], dtype=np.float32)
    return _affine_clip(imgs, m)


def _rotate(imgs, deg):
    import cv2

    h, w = imgs.shape[-2:]
    m = cv2.getRotationMatrix2D((w * 0.5, h * 0.5), deg, 1.0)
    return _affine_clip(imgs, m.astype(np.float32))


def _posterize(imgs, bits):
    mask = 255 - (2 ** (8 - bits) - 1)
    return (imgs.astype(np.uint8) & mask).astype(np.float32)


def _solarize(imgs, threshold):
    return np.where(imgs >= threshold, 255.0 - imgs, imgs)


def _autocontrast(imgs):
    # per frame, per channel
    lo = imgs.min(axis=(-2, -1), keepdims=True)
    hi = imgs.max(axis=(-2, -1), keepdims=True)
    scale = np.where(hi > lo, 255.0 / np.maximum(hi - lo, 1e-6), 1.0)
    out = np.where(hi > lo, (imgs - lo) * scale, imgs)
    return np.clip(out, 0, 255)


def _equalize(imgs):
    import cv2

    t, c, h, w = imgs.shape
    out = np.empty_like(imgs)
    u8 = np.clip(imgs, 0, 255).astype(np.uint8)
    for i in range(t):
        for ch in range(c):
            out[i, ch] = cv2.equalizeHist(u8[i, ch]).astype(np.float32)
    return out


def _sharpness(imgs, factor):
    import cv2

    kernel = np.array([[1, 1, 1], [1, 5, 1], [1, 1, 1]],
                      dtype=np.float32) / 13.0
    t, c, h, w = imgs.shape
    smooth = np.empty_like(imgs)
    for i in range(t):
        for ch in range(c):
            sm = cv2.filter2D(imgs[i, ch], -1, kernel,
                              borderType=cv2.BORDER_REPLICATE)
            # PIL keeps the 1-pixel border unsmoothed
            sm[0, :] = imgs[i, ch, 0, :]
            sm[-1, :] = imgs[i, ch, -1, :]
            sm[:, 0] = imgs[i, ch, :, 0]
            sm[:, -1] = imgs[i, ch, :, -1]
            smooth[i, ch] = sm
    return np.clip(factor * imgs + (1 - factor) * smooth, 0, 255)


class RandAugment:
    """num_ops random ops at the given magnitude, one draw per clip."""

    def __init__(self, num_ops=2, magnitude=9, num_magnitude_bins=31):
        self.num_ops = num_ops
        self.magnitude = magnitude
        self.bins = num_magnitude_bins
        self._chosen = []

    def _space(self):
        b = self.bins
        return {
            "Identity": (None, False),
            "ShearX": (np.linspace(0.0, 0.3, b), True),
            "ShearY": (np.linspace(0.0, 0.3, b), True),
            "TranslateX": (np.linspace(0.0, 150.0 / 331.0, b), True),
            "TranslateY": (np.linspace(0.0, 150.0 / 331.0, b), True),
            "Rotate": (np.linspace(0.0, 30.0, b), True),
            "Brightness": (np.linspace(0.0, 0.9, b), True),
            "Color": (np.linspace(0.0, 0.9, b), True),
            "Contrast": (np.linspace(0.0, 0.9, b), True),
            "Sharpness": (np.linspace(0.0, 0.9, b), True),
            "Posterize": (8 - (np.arange(b) / ((b - 1) / 4)).round(),
                          False),
            "Solarize": (np.linspace(255.0, 0.0, b), False),
            "AutoContrast": (None, False),
            "Equalize": (None, False),
        }

    def randomize_parameters(self):
        space = self._space()
        names = list(space.keys())
        rng = T._global_rng
        self._chosen = []
        for _ in range(self.num_ops):
            name = names[int(rng.integers(0, len(names)))]
            mags, signed = space[name]
            mag = float(mags[self.magnitude]) if mags is not None else 0.0
            if signed and rng.random() > 0.5:
                mag = -mag
            self._chosen.append((name, mag))

    def __call__(self, imgs):
        imgs = np.asarray(imgs, dtype=np.float32)
        h, w = imgs.shape[-2:]
        for name, mag in self._chosen:
            if name == "Identity":
                continue
            elif name == "ShearX":
                imgs = _shear(imgs, sx=mag)
            elif name == "ShearY":
                imgs = _shear(imgs, sy=mag)
            elif name == "TranslateX":
                imgs = _translate(imgs, tx=int(mag * w))
            elif name == "TranslateY":
                imgs = _translate(imgs, ty=int(mag * h))
            elif name == "Rotate":
                imgs = _rotate(imgs, mag)
            elif name == "Brightness":
                imgs = np.clip(imgs * (1.0 + mag), 0, 255)
            elif name == "Color":
                gray = T.rgb_to_grayscale(imgs)
                imgs = np.clip((1.0 + mag) * imgs + (-mag) * gray, 0, 255)
            elif name == "Contrast":
                mean = T.rgb_to_grayscale(imgs).mean(axis=(-3, -2, -1),
                                                     keepdims=True)
                imgs = np.clip((1.0 + mag) * imgs + (-mag) * mean, 0, 255)
            elif name == "Sharpness":
                imgs = _sharpness(imgs, 1.0 + mag)
            elif name == "Posterize":
                imgs = _posterize(imgs, int(mag))
            elif name == "Solarize":
                imgs = _solarize(imgs, mag)
            elif name == "AutoContrast":
                imgs = _autocontrast(imgs)
            elif name == "Equalize":
                imgs = _equalize(imgs)
        return imgs
