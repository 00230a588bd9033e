"""Clip-consistent video transforms on the host, and the notebook's eval
transform.

Port of ``videotransformer_tpu/data/transforms.py`` (the reference's
data_transform.py): the classes ``Compose`` through ``TemporalRandomCrop``
with the ``randomize_parameters()`` protocol (one draw applies to every
frame of a clip), drawing from the module's numpy Generator
(``seed_transforms`` reseeds it), and the builders ``transforms_train``,
``transforms_eval`` and ``create_video_transform``. Clips are numpy (T, C,
H, W); outputs are float32. Resizes are the two weight products of
``data/interpolation.py``. These feed the ``-device_augment False`` path.

``eval_transform_clip`` is the reference notebook's eval chain, Resize(-1,
256) -> ThreeCrop(224) -> ToTensor -> Normalize, of these classes; the
serving path uses it.
"""

import math
from collections.abc import Sequence

import numpy as np
import torch

from videotransformer_tpu_torch.data.interpolation import (
    resize_hw, resize_short_edge)

DEFAULT_CROP_PCT = 0.875
IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD = \
    (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
SHORT_EDGE = 256  # Resize(-1, 256) of the notebook's eval chain

_global_rng = np.random.default_rng(0)


def seed_transforms(seed: int):
    """Reseed the module's generator (the reference seeds ``random``)."""
    global _global_rng
    _global_rng = np.random.default_rng(seed)


def _resize(imgs, out_h, out_w, method):
    """numpy (..., H, W) -> float32 (..., out_h, out_w)."""
    x = torch.from_numpy(np.ascontiguousarray(imgs, dtype=np.float32))
    return resize_hw(x, out_h, out_w, method).numpy()


class Compose:
    """data_transform.py:31-49."""

    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, imgs):
        for t in self.transforms:
            imgs = t(imgs)
        return imgs

    def randomize_parameters(self):
        for t in self.transforms:
            if hasattr(t, "randomize_parameters"):
                t.randomize_parameters()


class ToTensor:
    """Scale to [0, 1] float32 (data_transform.py:52-67)."""

    def __init__(self, norm_value=255):
        self.norm_value = norm_value

    def __call__(self, pic):
        return np.asarray(pic, dtype=np.float32) / self.norm_value

    def randomize_parameters(self):
        pass


class Normalize:
    """Channel-wise normalize of imgs (T, C, H, W) (data_transform.py:
    301-335)."""

    def __init__(self, mean, std):
        if not isinstance(mean, Sequence):
            raise TypeError(f"Mean must be list, tuple or np.ndarray, but "
                            f"got {type(mean)}")
        if not isinstance(std, Sequence):
            raise TypeError(f"Std must be list, tuple or np.ndarray, but "
                            f"got {type(std)}")
        self.mean = np.asarray(mean, dtype=np.float32).reshape(1, -1, 1, 1)
        self.std = np.asarray(std, dtype=np.float32).reshape(1, -1, 1, 1)

    def __call__(self, imgs):
        return (np.asarray(imgs, dtype=np.float32) - self.mean) / self.std

    def randomize_parameters(self):
        pass


class RandomCrop:
    """data_transform.py:73-108."""

    def __init__(self, size):
        if isinstance(size, tuple):
            if size[0] != size[1]:
                raise ValueError(
                    f"crop size {size[0], size[1]}, must be equal.")
            size = size[0]
        self.size = size
        self.x_jitter = 0.0
        self.y_jitter = 0.0

    def __call__(self, imgs):
        size = self.size
        img_height, img_width = imgs.shape[-2], imgs.shape[-1]
        y_offset = int(self.y_jitter * (img_height - size))
        x_offset = int(self.x_jitter * (img_width - size))
        return imgs[..., y_offset:y_offset + size, x_offset:x_offset + size]

    def randomize_parameters(self):
        self.x_jitter = float(_global_rng.random())
        self.y_jitter = float(_global_rng.random())


class Resize:
    """Short-edge (or random short-edge) resize (data_transform.py:111-141).

    scale_range=(-1, s): fixed short edge s. (a, b): random short edge in
    [a, b].
    """

    def __init__(self, scale_range, interpolation="bilinear"):
        if not isinstance(scale_range, tuple):
            raise ValueError(f"Scale_range {scale_range}, must be tuple.")
        self.scale_range = scale_range
        self.interpolation = interpolation
        self._short_edge = scale_range[1]

    def __call__(self, imgs):
        x = torch.from_numpy(np.ascontiguousarray(imgs, dtype=np.float32))
        return resize_short_edge(x, self._short_edge,
                                 self.interpolation).numpy()

    def randomize_parameters(self):
        if self.scale_range[0] == -1:
            self._short_edge = self.scale_range[1]
        else:
            self._short_edge = int(_global_rng.integers(
                self.scale_range[0], self.scale_range[1] + 1))


class RandomResizedCrop:
    """Frame-consistent area/aspect random crop + resize
    (data_transform.py:144-209, the clip-consistent "version two")."""

    def __init__(self, size, interpolation="bicubic", scale=(0.08, 1.0),
                 ratio=(3 / 4, 4 / 3)):
        self.size = size if isinstance(size, tuple) else (size, size)
        self.area_range = scale
        self.aspect_ratio_range = ratio
        self.interpolation = interpolation
        self.scale = 1.0
        self.ratio = 1.0
        self.tl_x = 0.0
        self.tl_y = 0.0

    def __call__(self, imgs):
        imgs = np.asarray(imgs, dtype=np.float32)
        img_width = imgs.shape[-1]
        img_height = imgs.shape[-2]
        min_length = min(img_width, img_height)
        crop_size = int(min_length * self.scale)
        width = crop_size
        height = crop_size * self.ratio
        left = self.tl_x * (img_width - width)
        top = self.tl_y * (img_height - height)
        top, left, height, width = int(top), int(left), int(height), int(width)
        crop = imgs[..., top:top + height, left:left + width]
        return _resize(crop, self.size[0], self.size[1], self.interpolation)

    def randomize_parameters(self):
        self.scale = float(_global_rng.uniform(*self.area_range))
        self.ratio = float(_global_rng.uniform(*self.aspect_ratio_range))
        self.tl_x = float(_global_rng.random())
        self.tl_y = float(_global_rng.random())


class TorchvisionRandomResizedCrop:
    """torchvision-style RandomResizedCrop: uniform area scale, log-uniform
    aspect ratio, 10 attempts then center fallback; clip-consistent (one draw
    per call). Used by transforms_train (data_transform.py:514-515)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bicubic"):
        self.size = size if isinstance(size, tuple) else (size, size)
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation
        self._params_for = None
        self._ijhw = None

    def _get_params(self, height, width):
        area = height * width
        log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
        for _ in range(10):
            target_area = area * float(_global_rng.uniform(*self.scale))
            aspect_ratio = math.exp(float(_global_rng.uniform(*log_ratio)))
            w = int(round(math.sqrt(target_area * aspect_ratio)))
            h = int(round(math.sqrt(target_area / aspect_ratio)))
            if 0 < w <= width and 0 < h <= height:
                i = int(_global_rng.integers(0, height - h + 1))
                j = int(_global_rng.integers(0, width - w + 1))
                return i, j, h, w
        # fallback: center crop at clamped aspect
        in_ratio = float(width) / float(height)
        if in_ratio < min(self.ratio):
            w = width
            h = int(round(w / min(self.ratio)))
        elif in_ratio > max(self.ratio):
            h = height
            w = int(round(h * max(self.ratio)))
        else:
            w, h = width, height
        i = (height - h) // 2
        j = (width - w) // 2
        return i, j, h, w

    def __call__(self, imgs):
        imgs = np.asarray(imgs, dtype=np.float32)
        h, w = imgs.shape[-2], imgs.shape[-1]
        if self._params_for != (h, w):
            # draw lazily for the actual clip size (clip-consistent)
            self._ijhw = self._get_params(h, w)
            self._params_for = (h, w)
        i, j, ch, cw = self._ijhw
        crop = imgs[..., i:i + ch, j:j + cw]
        return _resize(crop, self.size[0], self.size[1], self.interpolation)

    def randomize_parameters(self):
        self._params_for = None
        self._ijhw = None


class Flip:
    """Horizontal flip with probability (data_transform.py:212-238)."""

    def __init__(self, flip_ratio=0.5):
        self.flip_ratio = flip_ratio
        self._do_flip = False

    def __call__(self, imgs):
        if self._do_flip:
            return np.ascontiguousarray(imgs[..., ::-1])
        return imgs

    def randomize_parameters(self):
        # reference flips when p > flip_ratio (data_transform.py:233-238), i.e.
        # with probability (1 - flip_ratio); preserved for parity.
        self._do_flip = float(_global_rng.random()) > self.flip_ratio


def rgb_to_grayscale(imgs):
    """(..., C, H, W) -> (..., 1, H, W), ITU-R 601-2 weights (torchvision)."""
    r, g, b = imgs[..., 0, :, :], imgs[..., 1, :, :], imgs[..., 2, :, :]
    return (0.2989 * r + 0.587 * g + 0.114 * b)[..., None, :, :]


class RandomGrayscale:
    """data_transform.py:241-267."""

    def __init__(self, p=0.1):
        self.p = p
        self._do = False

    def __call__(self, imgs):
        if self._do:
            gray = rgb_to_grayscale(np.asarray(imgs, dtype=np.float32))
            return np.repeat(gray, imgs.shape[-3], axis=-3)
        return imgs

    def randomize_parameters(self):
        self._do = float(_global_rng.random()) <= self.p


class RandomApply:
    """data_transform.py:270-298."""

    def __init__(self, transform, p=0.5):
        self.p = p
        self.transform = transform if isinstance(transform, list) \
            else [transform]
        self._do = False

    def __call__(self, imgs):
        if self._do:
            for t in self.transform:
                imgs = t(imgs)
        return imgs

    def randomize_parameters(self):
        self._do = float(_global_rng.random()) <= self.p
        for t in self.transform:
            if hasattr(t, "randomize_parameters"):
                t.randomize_parameters()


def _blend(img1, img2, ratio, bound=255.0):
    return np.clip(ratio * img1 + (1.0 - ratio) * img2, 0.0, bound)


def _rgb_to_hsv(img):
    """img (..., 3, H, W) in [0, 1]. torchvision _rgb2hsv equivalent."""
    r, g, b = img[..., 0, :, :], img[..., 1, :, :], img[..., 2, :, :]
    maxc = np.maximum(np.maximum(r, g), b)
    minc = np.minimum(np.minimum(r, g), b)
    eqc = maxc == minc
    cr = maxc - minc
    ones = np.ones_like(maxc)
    s = cr / np.where(eqc, ones, maxc)
    cr_divisor = np.where(eqc, ones, cr)
    rc = (maxc - r) / cr_divisor
    gc = (maxc - g) / cr_divisor
    bc = (maxc - b) / cr_divisor
    hr = (maxc == r) * (bc - gc)
    hg = ((maxc == g) & (maxc != r)) * (2.0 + rc - bc)
    hb = ((maxc != g) & (maxc != r)) * (4.0 + gc - rc)
    h = hr + hg + hb
    h = (h / 6.0 + 1.0) % 1.0
    return np.stack([h, s, maxc], axis=-3)


def _hsv_to_rgb(img):
    h, s, v = img[..., 0, :, :], img[..., 1, :, :], img[..., 2, :, :]
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    i = i.astype(np.int32) % 6
    p = np.clip(v * (1.0 - s), 0.0, 1.0)
    q = np.clip(v * (1.0 - s * f), 0.0, 1.0)
    t = np.clip(v * (1.0 - s * (1.0 - f)), 0.0, 1.0)
    mask = i[..., None, :, :] == np.arange(6).reshape(-1, 1, 1)
    a1 = np.stack([v, q, p, p, t, v], axis=-3)
    a2 = np.stack([t, v, v, q, p, p], axis=-3)
    a3 = np.stack([p, p, t, v, v, q], axis=-3)
    a4 = np.stack([a1, a2, a3], axis=-4)
    return np.einsum("...ijk,...xijk->...xjk", mask.astype(img.dtype), a4)


class ColorJitter:
    """Clip-consistent brightness/contrast/saturation/hue jitter.

    torchvision semantics (the reference's transforms_train uses torchvision
    ColorJitter at data_transform.py:531): factors drawn once per clip, ops
    applied in a random order.
    """

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        self._order = [0, 1, 2, 3]
        self._b = self._c = self._s = 1.0
        self._h = 0.0

    def __call__(self, imgs):
        imgs = np.asarray(imgs, dtype=np.float32)
        bound = 255.0 if imgs.max() > 1.5 else 1.0
        for op in self._order:
            if op == 0 and self.brightness:
                imgs = _blend(imgs, np.zeros_like(imgs), self._b, bound)
            elif op == 1 and self.contrast:
                mean = rgb_to_grayscale(imgs).mean(axis=(-3, -2, -1),
                                                   keepdims=True)
                imgs = _blend(imgs, mean, self._c, bound)
            elif op == 2 and self.saturation:
                imgs = _blend(imgs, rgb_to_grayscale(imgs), self._s, bound)
            elif op == 3 and self.hue and self._h != 0.0:
                scaled = imgs / bound
                hsv = _rgb_to_hsv(scaled)
                hsv[..., 0, :, :] = (hsv[..., 0, :, :] + self._h) % 1.0
                imgs = _hsv_to_rgb(hsv) * bound
        return imgs

    def randomize_parameters(self):
        def factor(s):
            return float(_global_rng.uniform(max(0, 1 - s), 1 + s)) if s \
                else 1.0

        self._b = factor(self.brightness)
        self._c = factor(self.contrast)
        self._s = factor(self.saturation)
        self._h = float(_global_rng.uniform(-self.hue, self.hue)) \
            if self.hue else 0.0
        self._order = list(_global_rng.permutation(4))


class CenterCrop:
    """data_transform.py:389-409."""

    def __init__(self, size):
        self.size = size if isinstance(size, tuple) else (size, size)

    def __call__(self, imgs):
        h, w = imgs.shape[-2], imgs.shape[-1]
        th, tw = self.size
        i = int(round((h - th) / 2.0))
        j = int(round((w - tw) / 2.0))
        return imgs[..., i : i + th, j : j + tw]

    def randomize_parameters(self):
        pass


class ThreeCrop:
    """Left/right/center square crops -> (3, T, C, size, size)
    (data_transform.py:412-469)."""

    def __init__(self, size):
        if isinstance(size, tuple):
            if size[0] != size[1]:
                raise ValueError(
                    f"crop size {size[0], size[1]}, must be equal.")
            size = size[0]
        self.size = size

    def __call__(self, imgs):
        size = int(self.size)
        img_height, img_width = imgs.shape[-2], imgs.shape[-1]
        if size > img_height or size > img_width:
            raise ValueError(
                f"Requested crop size {size} is bigger than input size "
                f"{(img_height, img_width)}"
            )
        y, xc = (img_height - size) // 2, (img_width - size) // 2
        return np.stack([imgs[..., y:y + size, x:x + size]
                         for x in (0, img_width - size, xc)])

    def randomize_parameters(self):
        pass


class TemporalRandomCrop:
    """Random temporal window of `size` frames (data_transform.py:475-489)."""

    def __init__(self, size):
        self.size = size

    def __call__(self, total_frames):
        rand_end = max(0, total_frames - self.size - 1)
        begin_index = int(_global_rng.integers(0, rand_end + 1))
        end_index = min(begin_index + self.size, total_frames)
        return begin_index, end_index


# ---------------------------------------------------------------------------
# timm-style builders (data_transform.py:495-615)
# ---------------------------------------------------------------------------

def transforms_train(img_size=224, scale=None, ratio=None, hflip=0.5,
                     color_jitter=0.4, auto_augment=None,
                     interpolation="bicubic",
                     mean=IMAGENET_DEFAULT_MEAN, std=IMAGENET_DEFAULT_STD,
                     objective="supervised"):
    scale = tuple(scale or (0.08, 1.0))
    ratio = tuple(ratio or (3.0 / 4.0, 4.0 / 3.0))
    if interpolation == "random":
        interpolation = "bicubic"
    primary_tfl = [
        TorchvisionRandomResizedCrop(img_size, scale=scale, ratio=ratio,
                                     interpolation=interpolation)
    ]
    if hflip > 0.0:
        primary_tfl += [Flip(flip_ratio=hflip)]

    secondary_tfl = []
    if auto_augment:
        from videotransformer_tpu_torch.data.rand_augment import RandAugment

        secondary_tfl += [RandAugment()]
    elif color_jitter is not None:
        if isinstance(color_jitter, (list, tuple)):
            assert len(color_jitter) in (3, 4)
        else:
            color_jitter = (float(color_jitter),) * 3
        secondary_tfl += [ColorJitter(*color_jitter)]

    final_tfl = [ToTensor(), Normalize(list(mean), list(std))]
    if objective == "mim":
        return [Compose(primary_tfl + secondary_tfl), Compose(final_tfl)]
    return Compose(primary_tfl + secondary_tfl + final_tfl)


def transforms_eval(img_size=224, crop_pct=None, interpolation="bilinear",
                    mean=IMAGENET_DEFAULT_MEAN, std=IMAGENET_DEFAULT_STD):
    crop_pct = crop_pct or DEFAULT_CROP_PCT
    if isinstance(img_size, (tuple, list)):
        assert len(img_size) == 2
        if img_size[-1] == img_size[-2]:
            scale_size = int(math.floor(img_size[0] / crop_pct))
        else:
            scale_size = tuple([int(x / crop_pct) for x in img_size])
    else:
        scale_size = int(math.floor(img_size / crop_pct))

    tfl = [
        Resize((-1, scale_size), interpolation=interpolation),
        CenterCrop(img_size),
        ToTensor(),
        Normalize(list(mean), list(std)),
    ]
    return Compose(tfl)


def create_video_transform(input_size=224, is_training=False, scale=None,
                           ratio=None, hflip=0.5, color_jitter=0.4,
                           auto_augment=None, interpolation="bilinear",
                           mean=IMAGENET_DEFAULT_MEAN,
                           std=IMAGENET_DEFAULT_STD, objective="supervised",
                           crop_pct=None):
    if isinstance(input_size, (tuple, list)):
        img_size = input_size[-2:]
    else:
        img_size = input_size

    if is_training:
        return transforms_train(
            img_size, scale=scale, ratio=ratio, hflip=hflip,
            color_jitter=color_jitter, auto_augment=auto_augment,
            interpolation=interpolation, mean=mean, std=std,
            objective=objective)
    return transforms_eval(
        img_size, interpolation=interpolation, mean=mean, std=std,
        crop_pct=crop_pct)


def temporal_window(total_frames, size, rng):
    """A random window of ``size`` frames drawn from the numpy Generator
    ``rng`` -> (begin, end) (transforms.py:428-438)."""
    rand_end = max(0, total_frames - size - 1)
    begin = int(rng.integers(0, rand_end + 1))
    return begin, min(begin + size, total_frames)


def eval_transform_clip(video, mean, std, img_size=224):
    """(T, H, W, C) uint8 frames -> Resize(-1, 256) (bilinear) -> ThreeCrop
    -> ToTensor -> Normalize -> (3, T, C, img_size, img_size) float32."""
    return Compose([Resize((-1, SHORT_EDGE)), ThreeCrop(img_size), ToTensor(),
                    Normalize(list(mean), list(std))])(
        np.transpose(video, (0, 3, 1, 2)))
