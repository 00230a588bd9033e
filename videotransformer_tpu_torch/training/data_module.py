"""The Kinetics data module: per-objective recipes and the three loaders.

Port of ``videotransformer_tpu/training/data_module.py`` (the reference's
data_trainer.py:38-154), for one process:

- mim: RandomResizedCrop scale (0.5, 1.0) + flip, no colour jitter, the
  transform split [geometric, ToTensor + Normalize]; supervised: colour
  jitter 0.4 (or RandAugment with ``auto_augment``);
- dataset statistics: imagenet, kinetics, else 0.5;
- val = Resize(short = img_size / crop_pct) + CenterCrop; test =
  Resize(short 256) + ThreeCrop(img_size);
- ``device_augment`` (supervised and mim): the datasets return canonical
  uint8 clips and the train step augments them on the device; supervised
  runs also validate and test from uint8 clips (``device_eval``), with the
  eval recipe on the device;
- mim: HOG targets on the host (``host_hog_targets``) unless the device
  computes them (``device_augment`` or ``device_hog``).
"""

import numpy as np

from videotransformer_tpu_torch.data import transforms as T
from videotransformer_tpu_torch.data.dataset import Kinetics
from videotransformer_tpu_torch.data.pipeline import (
    Loader, collate_mim, collate_mim_raw, collate_raw, collate_supervised)


def dataset_statistics(name):
    """(mean, std) of the normalisation named ``name``."""
    if name == "imagenet":
        return (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    if name == "kinetics":
        return (0.45, 0.45, 0.45), (0.225, 0.225, 0.225)
    return (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)


class ThreeCropCollate:
    """Test samples carry (3, T, C, H, W); the crops go into the batch."""

    def __call__(self, samples):
        videos = np.concatenate([s[0] for s in samples],
                                axis=0).astype(np.float32)
        labels = np.asarray([s[1] for s in samples], dtype=np.int32)
        return {"video": videos, "label": labels}


class KineticsDataModule:
    def __init__(self, configs, train_ann_path=None, val_ann_path=None,
                 test_ann_path=None, host_hog_targets=True):
        self.configs = configs
        self.train_ann_path = train_ann_path
        self.val_ann_path = val_ann_path
        self.test_ann_path = test_ann_path
        self.host_hog_targets = host_hog_targets
        self.setup()

    def setup(self):
        cfg = self.configs
        mim = cfg.objective == "mim"
        scale, color_jitter = ((0.5, 1.0), None) if mim else (None, 0.4)
        mean, std = dataset_statistics(getattr(cfg, "data_statics",
                                               "kinetics"))
        self.mean, self.std = mean, std
        temporal_sample = T.TemporalRandomCrop(
            cfg.num_frames * cfg.frame_interval)
        # a bounded resample loop: a corrupt shard fails in a worker, and
        # the loader raises it, instead of spinning in __getitem__
        retries = getattr(cfg, "max_decode_retries", 100)
        self.device_augment = bool(getattr(cfg, "device_augment", False)) \
            and cfg.objective in ("supervised", "mim")
        # mim has no val/test loop: the eval recipe on the device is for
        # supervised runs only
        self.device_eval = self.device_augment and not mim
        if mim and (self.device_augment
                    or bool(getattr(cfg, "device_hog", False))):
            self.host_hog_targets = False

        def dataset(path, transform=None, raw=False, **kw):
            if not path:
                return None
            return Kinetics(cfg, path, transform=transform,
                            temporal_sample=temporal_sample, raw_clips=raw,
                            max_decode_retries=retries, **kw)

        if self.device_augment:
            self.train_dataset = dataset(self.train_ann_path, raw=True)
        else:
            self.train_dataset = dataset(
                self.train_ann_path, T.create_video_transform(
                    objective=cfg.objective, input_size=cfg.img_size,
                    is_training=True, scale=scale, hflip=0.5,
                    color_jitter=color_jitter,
                    auto_augment=getattr(cfg, "auto_augment", None),
                    interpolation="bicubic", mean=mean, std=std),
                host_hog_targets=self.host_hog_targets)
        if self.device_eval:
            self.val_dataset = dataset(self.val_ann_path, raw=True)
            self.test_dataset = dataset(self.test_ann_path, raw=True)
        else:
            self.val_dataset = dataset(
                self.val_ann_path, T.create_video_transform(
                    input_size=cfg.img_size, is_training=False,
                    interpolation="bicubic", mean=mean, std=std))
            self.test_dataset = dataset(self.test_ann_path, T.Compose([
                T.Resize(scale_range=(-1, 256)),
                T.ThreeCrop(size=cfg.img_size), T.ToTensor(),
                T.Normalize(list(mean), list(std))]))

    def _loader(self, dataset, shuffle, drop_last, collate_fn):
        if dataset is None:
            return None
        cfg = self.configs
        return Loader(dataset, batch_size=cfg.batch_size, shuffle=shuffle,
                      drop_last=drop_last,
                      num_workers=getattr(cfg, "num_workers", 2),
                      collate_fn=collate_fn, seed=getattr(cfg, "seed", 0))

    def train_loader(self):
        mim = self.configs.objective == "mim"
        if self.device_augment:
            collate = collate_mim_raw if mim else collate_raw
        else:
            collate = collate_mim if mim else collate_supervised
        return self._loader(self.train_dataset, shuffle=True, drop_last=True,
                            collate_fn=collate)

    def val_loader(self):
        collate = collate_raw if self.device_eval else collate_supervised
        return self._loader(self.val_dataset, shuffle=False, drop_last=False,
                            collate_fn=collate)

    def test_loader(self):
        collate = collate_raw if self.device_eval else ThreeCropCollate()
        return self._loader(self.test_dataset, shuffle=False,
                            drop_last=False, collate_fn=collate)
