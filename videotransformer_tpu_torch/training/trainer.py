"""Train / val / test harness of the port on one device.

Port of ``videotransformer_tpu/training/trainer.py::VideoTransformerTrainer``
(the reference's model_trainer.py:39-310) for three runs:

- ``objective='supervised'``, ``arch='timesformer'``;
- ``objective='mim'``: MaskFeat pretraining on the MViT-B trunk
  (trainer.py:65-74, 327-378), masked HOG-feature regression with no head.
  A batch is ``{"video", "mask", "cube_marker", "cube_count"}`` with either
  ``"hog"`` (the targets, (B, T, h, w, 108)) or ``"raw"`` (the clip before
  Normalize, (B, T, C, H, W) in 0-255): the HOG targets are then computed on
  the device at the cube-center frames only and scattered one-hot into
  (B, T, h, w, 108), as trainer.py:353-372 does;
- ``objective='supervised'``, ``arch='mvit'``: the same MaskFeat model, its
  features ``forward_features(x)[:, 0]`` into the head; ``decoder_pred`` is
  left out of the optimizer, and layer-wise LR decay applies when
  ``layer_decay != 1`` (trainer.py:218-222, 289-316; optimizer.py:414-416).

Shared by all three:

- losses: cross entropy, soft-target cross entropy under mixup
  (trainer.py:43-51); ``linear_prob`` trains only the head on frozen
  features (trainer.py:216-217, 407-410).
- per-epoch cosine LR with warmup or multistep, the cosine weight-decay ramp
  on the decay group (``current_lr``, ``current_wd``).
- per-parameter gradient clipping with the logged total norm, AdamW or
  SGD-nesterov (training/optimizer.py).
- top-1/top-5 counts; eval over 1 or 3 crops (logits averaged over the
  crops), with ``label == -1`` rows counted nowhere (trainer.py:438-492).
- last and best checkpoints with ``torch.save`` in place of orbax, and
  resume (trainer.py:609-685). Saves are synchronous.

``use_fp16`` means fp32 parameters with bf16 compute, as in the JAX package
(trainer.py:54-57): the clip is cast to bf16 and every parameter is cast to
bf16 at its use, so on a CUDA device the kernels run forward and backward,
and the gradients reach the fp32 parameters through the casts.

Design for one device: the device is an argument and nothing moves to
another one on its own; DropPath and mixup draw from one
``torch.Generator`` on that device, seeded at each step from the seed and
the global step (as the JAX trainer folds the step into its key,
trainer.py:520), so a resumed run draws what an uninterrupted one would
have drawn. There is no mesh. Not ported yet (they raise): data
parallelism, ``raw_video`` batches (device augmentation), the pretrained
weight import, and ViViT; a mim run keeps no periodic checkpoint.
"""

import os
import os.path as osp
import time

import torch

from videotransformer_tpu_torch.data.hog import batched_hog_targets
from videotransformer_tpu_torch.data.mixup import Mixup
from videotransformer_tpu_torch.models.convert import (
    state_dicts_to_trainer_tree, trainer_tree_to_state_dicts)
from videotransformer_tpu_torch.models.maskfeat import MaskFeat
from videotransformer_tpu_torch.models.timesformer import TimeSformer
from videotransformer_tpu_torch.ops import initializers as init
from videotransformer_tpu_torch.ops.blocks import ClassificationHead
from videotransformer_tpu_torch.training import schedules
from videotransformer_tpu_torch.training.metrics import (
    AccuracyMeter, topk_correct)
from videotransformer_tpu_torch.training.optimizer import (
    RefOptimizer, layer_scales)


def cross_entropy(logits, labels):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[:, None].long()).mean()


def soft_target_cross_entropy(logits, soft_targets):
    """timm SoftTargetCrossEntropy (model_trainer.py:89)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return (-soft_targets * logp).sum(dim=-1).mean()


def model_dtype(configs):
    """``use_fp16`` -> bf16 compute with fp32 parameters."""
    return torch.bfloat16 if getattr(configs, "use_fp16", False) \
        else torch.float32


def build_model(configs):
    """trainer.py:60-99: MaskFeat (two q-pool stages, 216 HOG features) for
    ``objective='mim'`` or ``arch='mvit'``, else TimeSformer."""
    if configs.objective == "mim" or configs.arch == "mvit":
        return MaskFeat(num_frames=configs.num_frames,
                        img_size=configs.img_size,
                        pool_q_stride_size=((1, 1, 2, 2), (3, 1, 2, 2)),
                        feature_dim=2 * 2 * 2 * 3 * 9)
    if configs.objective != "supervised" or configs.arch != "timesformer":
        raise NotImplementedError(
            f"objective {configs.objective!r} with arch {configs.arch!r} is "
            "not ported yet (supervised timesformer and mvit, and mim, are)")
    dpr = getattr(configs, "drop_path_rate", None)
    return TimeSformer(num_frames=configs.num_frames,
                       img_size=configs.img_size,
                       attention_type=configs.attention_type,
                       **({} if dpr is None else {"drop_path_rate": dpr}))


def _as_tensor(a, device, dtype=None):
    return torch.as_tensor(a).to(device=device, dtype=dtype,
                                 non_blocking=True)


class VideoTransformerTrainer:
    """``params``, when given, is the JAX trainer's parameter tree (numpy
    leaves) to start from; otherwise the JAX package's initialisation is
    drawn from ``seed``."""

    def __init__(self, configs, device, ckpt_dir=None, do_eval=False,
                 do_test=False, n_crops=3, seed=None, log_dir=None,
                 params=None):
        self.configs = configs
        self.device = torch.device(device)
        self.ckpt_dir = ckpt_dir
        self.do_eval = do_eval
        self.do_test = do_test
        self.n_crops = n_crops
        self._log_fh = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._log_fh = open(os.path.join(log_dir, "train.log"), "a")
        if getattr(configs, "pretrain_pth", None):
            raise NotImplementedError("pretrained-weight import is not "
                                      "ported yet")
        self.supervised = configs.objective == "supervised"
        self.is_mvit = getattr(configs, "arch", None) == "mvit"
        self.linear_prob = self.supervised and getattr(
            configs, "eval_metrics", "finetune") == "linear_prob"
        self.dtype = model_dtype(configs)
        seed = configs.seed if seed is None else seed
        self.seed = seed
        self.generator = torch.Generator(device=self.device)

        self.model = build_model(configs)
        self.cls_head = None
        if self.supervised:
            width = (self.model.embed_dims if isinstance(self.model, MaskFeat)
                     else self.model.cls_token.shape[-1])
            self.cls_head = ClassificationHead(configs.num_class, width)
        if params is None:
            g = torch.Generator().manual_seed(seed)
            self.model.reset_parameters(g)
            if self.cls_head is not None:
                self.cls_head.reset_parameters(g)
            if self.linear_prob:  # linear_prob head: N(0, 0.01)
                init.normal_(self.cls_head.cls_head.weight, g, std=0.01)
        else:
            self.load_params(params)
        self.model.to(self.device)
        self.mixup_fn = None
        named = []
        if self.cls_head is not None:
            self.cls_head.to(self.device)
            if getattr(configs, "mixup", False):
                self.mixup_fn = Mixup(num_classes=configs.num_class)
            named = [(f"cls_head.{n}", p)
                     for n, p in self.cls_head.named_parameters()]
        if not self.linear_prob:
            # supervised MViT: decoder_pred is frozen (trainer.py:218-222)
            named = [(f"model.{n}", p)
                     for n, p in self.model.named_parameters()
                     if not (self.supervised and self.is_mvit
                             and n.startswith("decoder_pred."))] + named
        lr_scales = None
        layer_decay = getattr(configs, "layer_decay", 1)
        if self.supervised and self.is_mvit and layer_decay != 1:
            lr_scales = layer_scales([n for n, _ in named], layer_decay)
        self.optimizer = RefOptimizer(
            named, optim_type=configs.optim_type,
            clip_grad=getattr(configs, "clip_grad", 0.0), lr_scales=lr_scales)

        self.max_top1_acc = 0.0
        self.epoch = 0
        self.global_step = 0
        self.train_meter = AccuracyMeter()
        self.val_meter = AccuracyMeter()
        self.test_meter = AccuracyMeter()

    # ------------------------------------------------------------------
    def load_params(self, tree):
        """Load the JAX trainer's parameter tree (numpy leaves): {"model",
        "cls_head"}, or {"model"} alone for a mim run."""
        model_sd, head_sd = trainer_tree_to_state_dicts(tree)
        as_t = lambda sd: {k: torch.from_numpy(v) for k, v in sd.items()}
        self.model.load_state_dict(as_t(model_sd), strict=True)
        if self.cls_head is not None:
            self.cls_head.load_state_dict(as_t(head_sd), strict=True)

    def params_tree(self):
        """The parameters as the JAX trainer's tree (fp32 numpy leaves)."""
        return state_dicts_to_trainer_tree(
            self.model.state_dict(),
            None if self.cls_head is None else self.cls_head.state_dict())

    def _features(self, video, generator=None):
        """The head's input: ``forward_features(x)[:, 0]`` for MViT
        (trainer.py:311-316), the TimeSformer's cls features otherwise."""
        if self.is_mvit:
            return self.model.forward_features(video,
                                               generator=generator)[:, 0]
        return self.model(video, generator)

    # ------------------------------------------------------------------
    def train_step(self, batch, lr, wd):
        """One step: forward, backward, clip, update; counts one global step.
        Supervised: ``{"video": (B, T, C, H, W) float, "label": (B,) int}``,
        returning the loss, grad_norm, top1, top5 (device tensors) and bs.
        mim: the batch of the module doc, returning the loss and grad_norm."""
        self.generator.manual_seed(self.seed + self.global_step + 7919)
        self.global_step += 1
        if "raw_video" in batch:
            raise NotImplementedError("raw_video batches (device "
                                      "augmentation) are not ported yet")
        if not self.supervised:
            return self._mim_step(batch, lr, wd)
        video = _as_tensor(batch["video"], self.device, torch.float32)
        labels = _as_tensor(batch["label"], self.device)
        soft = None
        if self.mixup_fn is not None:
            video, soft = self.mixup_fn(video, labels, self.generator)
        video = video.to(self.dtype)
        self.optimizer.zero_grad()
        if self.linear_prob:
            self.model.eval()
            with torch.no_grad():
                feats = self._features(video)
        else:
            self.model.train()
            feats = self._features(video, self.generator)
        logits = self.cls_head(feats)
        if soft is not None:
            loss = soft_target_cross_entropy(logits, soft)
            acc_labels = soft.argmax(-1)
        else:
            loss = cross_entropy(logits, labels)
            acc_labels = labels
        loss.backward()
        grad_norm = self.optimizer.step(lr, wd)
        correct = topk_correct(logits.detach(), acc_labels)
        return {"loss": loss.detach(), "grad_norm": grad_norm,
                "top1": correct[1], "top5": correct[5],
                "bs": logits.shape[0]}

    def _hog_targets(self, raw, markers, counts):
        """HOG targets from the clip before Normalize (B, T, C, H, W), at the
        cube-center frames 2·start + span only, scattered one-hot into
        (B, T, h, w, 108) (trainer.py:353-372)."""
        frames = raw.permute(0, 1, 3, 4, 2)  # (B, T, H, W, C)
        B, T = frames.shape[:2]
        centers = markers[..., 0] * 2 + markers[..., 1]  # (B, M)
        m_idx = torch.arange(markers.shape[1], device=self.device)
        valid = (m_idx[None] < counts[:, None]).float()
        gathered = frames[torch.arange(B, device=self.device)[:, None],
                          centers.long()]  # (B, M, H, W, C)
        hog = batched_hog_targets(gathered)  # (B, M, h, w, 108)
        onehot = (centers[..., None] == torch.arange(T, device=self.device)
                  ).float() * valid[..., None]
        return torch.einsum("bmt,bmhwc->bthwc", onehot, hog)

    def _mim_step(self, batch, lr, wd):
        dev = self.device
        video = _as_tensor(batch["video"], dev, torch.float32).to(self.dtype)
        mask = _as_tensor(batch["mask"], dev)
        markers = _as_tensor(batch["cube_marker"], dev)
        counts = _as_tensor(batch["cube_count"], dev)
        if "hog" in batch:
            target = _as_tensor(batch["hog"], dev, torch.float32)
        else:
            target = self._hog_targets(
                _as_tensor(batch["raw"], dev, torch.float32), markers, counts)
        self.optimizer.zero_grad()
        self.model.train()
        _, loss = self.model(video, target, mask, markers, counts,
                             self.generator)
        loss.backward()
        grad_norm = self.optimizer.step(lr, wd)
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    @torch.no_grad()
    def eval_step(self, batch, n_crops):
        """Top-k counts of ``{"video": (B·n_crops, T, C, H, W), "label":
        (B,)}``, logits averaged over the crops; label -1 rows count
        nowhere."""
        if not self.supervised:
            raise ValueError("eval_step needs a supervised run (a mim run "
                             "has no head)")
        self.model.eval()
        video = _as_tensor(batch["video"], self.device, self.dtype)
        labels = _as_tensor(batch["label"], self.device)
        logits = self.cls_head(self._features(video))
        if n_crops > 1:
            logits = logits.reshape(-1, n_crops, logits.shape[-1]).mean(dim=1)
        correct = topk_correct(logits, labels)
        return {"top1": correct[1], "top5": correct[5],
                "bs": (labels >= 0).sum()}

    # ------------------------------------------------------------------
    def current_lr(self, max_epochs):
        cfg = self.configs
        if getattr(cfg, "lr_schedule", "cosine") == "multistep":
            return schedules.multistep_epoch(self.epoch, cfg.lr)
        return schedules.cosine_with_warmup_epoch(
            self.epoch, cfg.lr, cfg.warmup_epochs, max_epochs,
            objective=cfg.objective, min_lr=getattr(cfg, "min_lr", 5e-5))

    def current_wd(self, max_epochs):
        cfg = self.configs
        return schedules.cosine_weight_decay(
            self.epoch, max_epochs, cfg.weight_decay,
            getattr(cfg, "weight_decay_end", cfg.weight_decay))

    # ------------------------------------------------------------------
    def train_epoch(self, loader, max_epochs, log_interval=30):
        lr = self.current_lr(max_epochs)
        wd = self.current_wd(max_epochs)
        self.train_meter.reset()
        data_start = time.perf_counter()
        for i, batch in enumerate(loader):
            data_time = time.perf_counter() - data_start
            stats = self.train_step(batch, lr, wd)
            if self.supervised:
                self.train_meter.update({1: stats["top1"], 5: stats["top5"]},
                                        stats["bs"])
            if i % log_interval == 0:
                step_time = time.perf_counter() - data_start
                msg = (f"epoch {self.epoch} step {i} loss "
                       f"{float(stats['loss']):.4f} lr {lr:.3e} grad_norm "
                       f"{float(stats['grad_norm']):.3f} time {step_time:.3f} "
                       f"data_time {data_time:.3f}")
                if self.supervised:
                    msg += (f" top1 {self.train_meter.compute(1):.3f} top5 "
                            f"{self.train_meter.compute(5):.3f}")
                self.print(msg)
            data_start = time.perf_counter()
        if self.train_meter.total:
            self.print(
                f"{_now()} - Evaluating mean top1_acc:"
                f"{self.train_meter.compute(1):.3f}, top5_acc:"
                f"{self.train_meter.compute(5):.3f} of current training epoch")
        if self.ckpt_dir:
            self.save_checkpoint(osp.join(self.ckpt_dir, "last_checkpoint"))

    def _evaluate(self, loader, meter, n_crops, what):
        meter.reset()
        for batch in loader:
            stats = self.eval_step(batch, n_crops)
            meter.update({1: stats["top1"], 5: stats["top5"]}, stats["bs"])
        top1, top5 = meter.compute(1), meter.compute(5)
        self.print(f"{_now()} - Evaluating mean top1_acc:{top1:.3f}, "
                   f"top5_acc:{top5:.3f} of current {what} epoch")
        return top1, top5

    def validate(self, loader):
        if not (self.do_eval and self.supervised):
            return None
        top1, top5 = self._evaluate(loader, self.val_meter, 1, "validation")
        if self.ckpt_dir and top1 > self.max_top1_acc:
            ts = _now().replace(" ", "_").replace(":", "-")
            self.save_checkpoint(osp.join(
                self.ckpt_dir, f"{ts}_ep_{self.epoch}_top1_acc_{top1:.3f}"))
            self.max_top1_acc = top1
        return top1, top5

    def test(self, loader):
        if not (self.do_test and self.supervised):
            return None
        return self._evaluate(loader, self.test_meter, self.n_crops, "test")

    def fit(self, data_module, max_epochs):
        """Epochs from ``self.epoch`` (so a resumed trainer continues), over
        any object with ``train_loader()``, ``val_loader()`` and
        ``test_loader()`` (a loader may have ``set_epoch``)."""
        for epoch in range(self.epoch, max_epochs):
            self.epoch = epoch
            train_loader = data_module.train_loader()
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            self.train_epoch(train_loader, max_epochs,
                             getattr(self.configs, "log_interval", 30))
            val_loader = data_module.val_loader()
            if val_loader is not None:
                self.validate(val_loader)
        test_loader = data_module.test_loader()
        if test_loader is not None:
            self.test(test_loader)

    # ------------------------------------------------------------------
    def save_checkpoint(self, path):
        """Parameters, optimizer moments and progress to one file."""
        os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
        torch.save({"model": self.model.state_dict(),
                    "cls_head": (None if self.cls_head is None
                                 else self.cls_head.state_dict()),
                    "opt_state": self.optimizer.state_dict(),
                    "epoch": self.epoch + 1,
                    "global_step": self.global_step,
                    "max_top1_acc": self.max_top1_acc}, path)

    def load_checkpoint(self, path):
        payload = torch.load(path, map_location=self.device,
                             weights_only=True)
        self.model.load_state_dict(payload["model"], strict=True)
        if self.cls_head is not None:
            self.cls_head.load_state_dict(payload["cls_head"], strict=True)
        self.optimizer.load_state_dict(payload["opt_state"])
        self.epoch = int(payload["epoch"])
        self.global_step = int(payload["global_step"])
        self.max_top1_acc = float(payload["max_top1_acc"])

    def close(self):
        if self._log_fh is not None:
            self._log_fh.close()
            self._log_fh = None

    def print(self, *args):
        print(*args, flush=True)
        if self._log_fh is not None:
            print(*args, file=self._log_fh, flush=True)


def _now():
    return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime())
