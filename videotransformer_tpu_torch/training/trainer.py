"""Train / val / test harness of the port on one device.

Port of ``videotransformer_tpu/training/trainer.py::VideoTransformerTrainer``
(the reference's model_trainer.py:39-310) for these runs:

- ``objective='supervised'``, ``arch='timesformer'`` (divided space-time,
  joint space-time or space-only attention) or ``arch='vivit'``
  (fact_encoder, joint space-time or divided space-time attention);
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

Shared by all:

- losses: cross entropy, soft-target cross entropy under mixup
  (trainer.py:43-51); ``linear_prob`` trains only the head on frozen
  features (trainer.py:216-217, 407-410).
- per-epoch cosine LR with warmup or multistep, the cosine weight-decay ramp
  on the decay group (``current_lr``, ``current_wd``).
- ``raw_video`` batches, canonical uint8 clips (B, T, H, W, C): the train
  step augments them on the device (``data/device_augment.py``) with the
  supervised recipe of ``aug_scale``, ``aug_hflip``, ``aug_color`` and
  ``auto_augment`` (trainer.py:380-396), or mim's fixed recipe
  (trainer.py:328-346); the eval step runs the Center- or ThreeCrop recipe
  on them (trainer.py:443-455). ``train_epoch``, ``validate`` and ``test``
  read batches through ``data/pipeline.py::device_prefetch``.
- per-parameter gradient clipping with the logged total norm, AdamW or
  SGD-nesterov (training/optimizer.py).
- top-1/top-5 counts; eval over 1 or 3 crops (logits averaged over the
  crops), with ``label == -1`` rows counted nowhere (trainer.py:438-492).
- last, best and (mim) periodic checkpoints with ``torch.save`` in place
  of orbax, and resume (trainer.py:546-552, 609-685). Saves are
  synchronous.

``use_fp16`` means fp32 parameters with bf16 compute, as in the JAX package
(trainer.py:54-57): the clip is cast to bf16 and every parameter is cast to
bf16 at its use, so on a CUDA device the kernels run forward and backward,
and the gradients reach the fp32 parameters through the casts.

Design: the device is an argument and nothing moves to another one on its
own; the augment, mixup and DropPath draw, in that order, from one
``torch.Generator`` on that device, seeded at each step from the seed and
the global step (as the JAX trainer folds the step into its key,
trainer.py:520), so a resumed run draws what an uninterrupted one would
have drawn.

Data, sequence and tensor parallelism take a ``mesh``
(``parallel/mesh.py``; the JAX trainer's, trainer.py:104-137): one process
a rank, ``mesh.data`` ranks that each take their rows of the global batch,
``mesh.seq`` ranks that each hold part of every clip's tokens
(``parallel/sp.py``) and ``mesh.model`` ranks that each hold a Megatron
shard of the transformer blocks (``parallel/tp.py``; TimeSformer and
ViViT only, as in the JAX package). A step over the mesh computes what one
process computes on the global batch:

- the model is built with the mesh (``build_model``), and under tensor
  parallelism as this rank's shard of the full model that the seed
  initialises;
- every draw is made for the global batch and cut to the data rank's rows
  (the augment's, DropPath's); mixup pairs global row i with row B - 1 - i
  (JAX mixup.py:76), which for data rank r lies on rank W - 1 - r (at the
  same seq and model rank), so each rank exchanges its rows with that rank
  alone and mixes its own; the seq and model ranks of a data rank are
  handed the same batch (the first one's, broadcast), whatever their
  loaders drew;
- each rank's loss is its share of the global loss (the supervised mean
  over the data ranks, MaskFeat's masked sum over the global batch's mask
  count, maskfeat.py:151), and one coalesced all-reduce after the backward
  sums the gradients and the step's loss and top-k counts over the data
  group, in a fixed order, so that steps repeat to the bit (DDP's buckets
  would fill in the order the backward reaches them); with one data rank
  there is nothing to sum, and no all-reduce;
- under sequence parallelism (TimeSformer and ViViT) every seq rank
  computes the same logits from the replicated cls row and back-propagates
  its share loss / (data · seq), and the gradients and the loss are summed
  over the data and seq ranks (``Mesh.replica_group``), the top-k counts
  counted once (``parallel/sp.py``). MaskFeat and ``arch=mvit`` call
  nothing of it, as in the JAX package, whose seq ranks then repeat their
  data rank's work: here they are replicas, each the one process of its
  data rank, summed over the data group alone;
- the initial parameters are rank 0's (a broadcast), imported and loaded
  weights are full canonical states sharded after reading, and a
  checkpoint is the gathered canonical state in the single-process
  format, written by rank 0; rank 0 alone prints and logs;
- eval runs every data rank through the same number of batches of the
  same size, a short or missing batch padded with label -1 rows
  (``mesh.even_eval_batches``; the JAX trainer pads its global eval batch
  to the mesh, trainer.py:472-499), and sums the top-k counts over the
  data group at the end of a pass.

Without a mesh every step is the single-process one, unchanged. Pipeline
parallelism is a subclass (``training/pp_trainer.py``), whose ranks each
hold one stage of the model; the hooks it overrides are ``_place``,
``_set_model_state``, ``import_pretrained``, ``model_state_dict``,
``head_state_dict``, the moments' ``_gather_moments``/``_local_moments``,
``_supervised_step`` and ``_eval_step``.

``pretrain_pth`` imports weights after the initialisation, by the JAX
trainer's routes (trainer.py:184-213; ``import_pretrained``): a checkpoint
of this trainer (``save_checkpoint``'s layout, the JAX package's orbax
directory) gives its parameters alone, non-strict; MaskFeat/MViT builds
take the MaskFeat import; otherwise ``weights_from`` picks the ImageNet ViT
surgery or the Kinetics import.
"""

import os
import os.path as osp
import time

import torch
import torch.distributed as dist

from videotransformer_tpu_torch.data.device_augment import (
    augment_batch, draw_augment, eval_preprocess_batch)
from videotransformer_tpu_torch.data.hog import batched_hog_targets
from videotransformer_tpu_torch.data.mixup import Mixup
from videotransformer_tpu_torch.data.pipeline import device_prefetch
from videotransformer_tpu_torch.models import convert
from videotransformer_tpu_torch.models.convert import (
    state_dicts_to_trainer_tree, trainer_tree_to_state_dicts)
from videotransformer_tpu_torch.models.maskfeat import MaskFeat
from videotransformer_tpu_torch.models.timesformer import TimeSformer
from videotransformer_tpu_torch.models.vivit import ViViT
from videotransformer_tpu_torch.ops import initializers as init
from videotransformer_tpu_torch.ops.blocks import Attention, ClassificationHead
from videotransformer_tpu_torch.parallel import mesh as _mesh
from videotransformer_tpu_torch.parallel import tp as _tp
from videotransformer_tpu_torch.training import schedules
from videotransformer_tpu_torch.training.data_module import (
    dataset_statistics)
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


def build_model(configs, mesh=None):
    """trainer.py:60-99: MaskFeat (two q-pool stages, 216 HOG features) for
    ``objective='mim'`` or ``arch='mvit'``, else the ViViT or TimeSformer
    of ``arch`` with ``attention_type``, DropPath at ``drop_path_rate``
    where the configs set one and ``remat`` (MViT has none: MaskFeat
    ignores the flag, as in JAX); built for this rank of ``mesh`` (a
    parallel run's), with ``model`` > 1 ranks its shard of the blocks."""
    if configs.objective == "mim" or configs.arch == "mvit":
        _tp.validate("mvit", _mesh.model_ranks(mesh))
        return MaskFeat(num_frames=configs.num_frames,
                        img_size=configs.img_size,
                        pool_q_stride_size=((1, 1, 2, 2), (3, 1, 2, 2)),
                        feature_dim=2 * 2 * 2 * 3 * 9, mesh=mesh)
    models = {"vivit": ViViT, "timesformer": TimeSformer}
    if configs.arch not in models:
        raise ValueError(configs.arch)
    dpr = getattr(configs, "drop_path_rate", None)
    return models[configs.arch](
        num_frames=configs.num_frames, img_size=configs.img_size,
        attention_type=configs.attention_type, mesh=mesh,
        remat=bool(getattr(configs, "remat", False)),
        **({} if dpr is None else {"drop_path_rate": dpr}))


def _as_tensor(a, device, dtype=None):
    return torch.as_tensor(a).to(device=device, dtype=dtype,
                                 non_blocking=True)


class VideoTransformerTrainer:
    """``params``, when given, is the JAX trainer's parameter tree (numpy
    leaves) to start from; otherwise the JAX package's initialisation is
    drawn from ``seed``. ``mesh``: this rank's place in data and tensor
    parallelism (module doc); None for one process."""

    def __init__(self, configs, device, ckpt_dir=None, do_eval=False,
                 do_test=False, n_crops=3, seed=None, log_dir=None,
                 params=None, mesh=None):
        self.configs = configs
        self.device = torch.device(device)
        self.ckpt_dir = ckpt_dir
        self.do_eval = do_eval
        self.do_test = do_test
        self.n_crops = n_crops
        self.mesh = mesh
        self.tp = _mesh.model_ranks(mesh)
        self.is_main = mesh is None or mesh.rank == 0
        self._sharded = False  # self.model holds a model rank's shard
        self._log_fh = None
        if log_dir and self.is_main:
            os.makedirs(log_dir, exist_ok=True)
            self._log_fh = open(os.path.join(log_dir, "train.log"), "a")
        self.supervised = configs.objective == "supervised"
        self.is_mvit = getattr(configs, "arch", None) == "mvit"
        self.linear_prob = self.supervised and getattr(
            configs, "eval_metrics", "finetune") == "linear_prob"
        self.dtype = model_dtype(configs)
        seed = configs.seed if seed is None else seed
        self.seed = seed
        self.generator = torch.Generator(device=self.device)

        # one process: build_model(configs); under tensor parallelism the
        # full model first, sharded in _distribute
        self.model = build_model(configs) if mesh is None or self.tp > 1 \
            else build_model(configs, mesh)
        self.num_heads = next((m.num_heads for m in self.model.modules()
                               if isinstance(m, Attention)), None)
        # the seq ranks a clip's tokens are split over (MaskFeat's seq
        # ranks are replicas)
        self.seq_shards = 1 if isinstance(self.model, MaskFeat) \
            else _mesh.seq_ranks(mesh)
        if self.tp > 1:
            _tp.validate("mvit" if isinstance(self.model, MaskFeat)
                      else configs.arch, self.tp, self.num_heads)
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
        self.pretrained_keys = None  # (missing, unexpected) of the import
        if getattr(configs, "pretrain_pth", None):
            self.pretrained_keys = self.import_pretrained(configs.pretrain_pth)
        self._place()
        self.mixup_fn = None
        if self.supervised and getattr(configs, "mixup", False):
            self.mixup_fn = Mixup(num_classes=configs.num_class)
        named = [] if self.cls_head is None else [
            (f"cls_head.{n}", p) for n, p in self.cls_head.named_parameters()]
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
            clip_grad=getattr(configs, "clip_grad", 0.0), lr_scales=lr_scales,
            mesh=mesh, sharded=[n for n, _ in named
                                if self.tp > 1 and _tp.shard_dim(n) is not None])

        self.max_top1_acc = 0.0
        self.epoch = 0
        self.global_step = 0
        self.train_meter = AccuracyMeter()
        self.val_meter = AccuracyMeter()
        self.test_meter = AccuracyMeter()

    # ------------------------------------------------------------------
    def _place(self):
        """The model and the head on the device; under a mesh, rank 0's
        parameters on every rank (``_distribute``)."""
        self.model.to(self.device)
        if self.cls_head is not None:
            self.cls_head.to(self.device)
        if self.mesh is not None:
            self._distribute()

    def _distribute(self):
        """Rank 0's parameters to every rank, then this rank's shard of the
        blocks in place of the full model."""
        _mesh.broadcast_state(self.model)
        if self.cls_head is not None:
            _mesh.broadcast_state(self.cls_head)
        if self.tp > 1:
            full = self.model.state_dict()
            self.model = build_model(self.configs, self.mesh).to(self.device)
            self._sharded = True
            self._set_model_state(full)

    def _set_model_state(self, state, strict=True):
        """Load the full canonical model state ``state``, this rank's shard
        of it under tensor parallelism."""
        if self._sharded:
            state = _tp.shard_state_dict(state, self.tp,
                                         self.mesh.model_rank,
                                         self.num_heads)
        return self.model.load_state_dict(state, strict=strict)

    def model_state_dict(self):
        """The full canonical model state (gathered over the model group
        under tensor parallelism: every model rank must call it)."""
        state = self.model.state_dict()
        if not self._sharded:
            return state
        return _tp.gather_over_model(state, self.mesh, self.num_heads)

    def head_state_dict(self):
        """The classification head's state (None without a head)."""
        return None if self.cls_head is None else self.cls_head.state_dict()

    def _gather_moments(self, opt_state):
        """The optimizer state with the whole model's moments (gathered
        over the model group under tensor parallelism: every model rank
        must call it)."""
        if self._sharded:
            for k in ("mu", "nu"):
                opt_state[k] = _tp.gather_over_model(opt_state[k], self.mesh,
                                                     self.num_heads)
        return opt_state

    def _local_moments(self, opt_state):
        """``_gather_moments``'s inverse: this rank's part of a whole
        optimizer state."""
        if self._sharded:
            opt_state = dict(opt_state, **{
                k: _tp.shard_state_dict(opt_state[k], self.tp,
                                        self.mesh.model_rank, self.num_heads)
                for k in ("mu", "nu")})
        return opt_state

    def load_params(self, tree):
        """Load the JAX trainer's parameter tree (numpy leaves): {"model",
        "cls_head"}, or {"model"} alone for a mim run."""
        model_sd, head_sd = trainer_tree_to_state_dicts(tree)
        as_t = lambda sd: {k: torch.from_numpy(v) for k, v in sd.items()}
        self._set_model_state(as_t(model_sd))
        if self.cls_head is not None:
            self.cls_head.load_state_dict(as_t(head_sd), strict=True)

    def import_pretrained(self, path):
        """Weights from the checkpoint file ``path`` into the model, by the
        JAX trainer's routes (trainer.py:184-213), non-strict; returns
        (missing, unexpected) and prints them:

        - a checkpoint of this trainer (``is_port_checkpoint``; the JAX
          trainer's orbax directory, ``init_from_orbax_pretrain``): its
          model parameters only, no optimizer state, its head ignored. It
          is recognised before the generic unwrap, which would take its
          ``model`` entry and then cut 9 characters off every key;
        - ``arch='mvit'`` or ``objective='mim'``: the MaskFeat import,
          whatever ``weights_from`` says;
        - ``weights_from='imagenet'``: the ViT surgery, Conv3d for ViViT
          and Conv2d otherwise, ``repeat`` copies, tube 2, 4 temporal
          layers;
        - ``weights_from='kinetics'``: the Kinetics import;
        - anything else raises TypeError. A file that cannot be read
          raises.

        Under tensor parallelism the weights go into the full model (the
        shards gathered), which is then sharded again."""
        if not self._sharded:
            return self._import_into(self.model, path)
        return self._import_into_whole(path)

    def _import_into_whole(self, path):
        """``import_pretrained`` into the whole model put together from
        the ranks' parts, then this rank's part of it taken again."""
        full = build_model(self.configs).to(self.device)
        full.load_state_dict(self.model_state_dict())
        keys = self._import_into(full, path)
        self._set_model_state(full.state_dict())
        return keys

    def _import_into(self, model, path):
        cfg = self.configs
        payload = convert.read_checkpoint(path)
        if is_port_checkpoint(payload):
            return convert.merge_state_dict(model, payload["model"])
        if self.is_mvit or cfg.objective == "mim":
            return convert.init_maskfeat_from_kinetics_pretrain(model,
                                                                payload)
        weights_from = getattr(cfg, "weights_from", "imagenet")
        if weights_from == "imagenet":
            conv_type = "Conv3d" if cfg.arch == "vivit" else "Conv2d"
            return convert.init_from_vit_pretrain(
                model, payload, conv_type, cfg.attention_type, "repeat")
        if weights_from == "kinetics":
            return convert.init_from_kinetics_pretrain(model, payload)
        raise TypeError(f"not support the pretrained weight {path}")

    def params_tree(self):
        """The parameters as the JAX trainer's tree (fp32 numpy leaves), the
        full model's under tensor parallelism."""
        return state_dicts_to_trainer_tree(self.model_state_dict(),
                                           self.head_state_dict())

    def _features(self, video, generator=None):
        """The head's input: ``forward_features(x)[:, 0]`` for MViT
        (trainer.py:311-316), the TimeSformer's cls features otherwise."""
        if self.is_mvit:
            return self.model.forward_features(video,
                                               generator=generator)[:, 0]
        return self.model(video, generator)

    # ------------------------------------------------------------------
    def _augment(self, raw, mim=False):
        """The train augment of uint8 clips (B, T, H, W, C) on the device,
        its draws from ``self.generator``. Supervised: the recipe of the
        configs (trainer.py:380-396) -> (B, T, C, S, S). mim: RandomResized
        Crop scale (0.5, 1.0) and flip 0.5 only, whatever ``auto_augment``
        says (trainer.py:339-346; the reference's fault (a), which the port
        keeps) -> (normalised, before Normalize)."""
        cfg = self.configs
        if mim:
            recipe = {"scale": (0.5, 1.0), "hflip": 0.5,
                      "color": (0, 0, 0, 0), "auto_augment": False}
        else:
            recipe = {
                "scale": tuple(getattr(cfg, "aug_scale", (0.08, 1.0))),
                "hflip": getattr(cfg, "aug_hflip", 0.5),
                "color": tuple(getattr(cfg, "aug_color",
                                       (0.4, 0.4, 0.4, 0.0))),
                "auto_augment": bool(getattr(cfg, "auto_augment", None))}
        mean, std = dataset_statistics(getattr(cfg, "data_statics",
                                               "kinetics"))
        # drawn for the global batch, this data rank's rows kept
        data = 1 if self.mesh is None else self.mesh.data
        shape = (raw.shape[0] * data,) + raw.shape[1:]
        draws = _mesh.shard_batch(self.mesh, draw_augment(
            self.generator, shape, device=raw.device, **recipe))
        return augment_batch(raw, out_size=cfg.img_size, mean=mean, std=std,
                             with_raw=mim, draws=draws, **recipe)

    def _mixup(self, video, labels):
        """Mixup over the global batch (row i with row B - 1 - i): this
        rank's rows with the flipped rows of data rank W - 1 - r, which
        hold their partners (``mesh.partner_rows``)."""
        mesh = self.mesh
        if mesh is None or mesh.data == 1:
            return self.mixup_fn(video, labels, self.generator)
        return self.mixup_fn(video, labels, self.generator,
                             partner=(_mesh.partner_rows(video, mesh),
                                      _mesh.partner_rows(labels, mesh)))

    def _model_group_batch(self, batch):
        """The batch on the device, under tensor, sequence and pipeline
        parallelism the first rank's of its data rank (over the model
        group, then the seq group, then the pipe group): its ranks must run
        the same clips, and host draws made by loader threads need not
        agree."""
        batch = {k: v if v is None else _as_tensor(v, self.device)
                 .contiguous() for k, v in batch.items()}
        tensors = [v for v in batch.values() if v is not None]
        if self.tp > 1:
            _mesh.broadcast_(tensors, src=self.mesh.model_ranks[0],
                             group=self.mesh.model_group)
        if self.mesh.seq > 1:
            _mesh.broadcast_(tensors, src=self.mesh.seq_ranks[0],
                             group=self.mesh.seq_group)
        if self.mesh.pipe > 1:
            _mesh.broadcast_(tensors, src=self.mesh.pipe_ranks[0],
                             group=self.mesh.pipe_group)
        return batch

    def _reduce_step(self, loss, extra=()):
        """After the backward: sum the gradients, the loss shares and
        ``extra`` (counts) over the data group (the data and seq ranks
        under sequence parallelism, the counts then divided by the seq
        ranks that each counted them) in one all-reduce; returns the
        global loss and ``extra``. One rank holds them already."""
        seq = self.seq_shards
        if self.mesh.data * seq == 1:
            return loss.detach(), list(extra)
        stats = torch.stack([loss.detach().float()]
                            + [e.float() for e in extra])
        self.optimizer.reduce_gradients(
            [stats], self.mesh.replica_group if seq > 1 else None)
        return stats[0], [e / seq for e in stats[1:]]

    def train_step(self, batch, lr, wd):
        """One step: forward, backward, clip, update; counts one global step.
        Supervised: ``{"video": (B, T, C, H, W) float, "label": (B,) int}``
        or ``{"raw_video": (B, T, H, W, C) uint8, "label"}``, returning the
        loss, grad_norm, top1, top5 (device tensors) and bs. mim: the batch
        of the module doc, or ``{"raw_video", "mask", "cube_marker",
        "cube_count"}``, returning the loss and grad_norm."""
        self.generator.manual_seed(self.seed + self.global_step + 7919)
        self.global_step += 1
        if self.mesh is not None:
            batch = self._model_group_batch(batch)
        if not self.supervised:
            return self._mim_step(batch, lr, wd)
        return self._supervised_step(batch, lr, wd)

    def _train_inputs(self, batch):
        """(clips in the working type, labels, mixup's soft targets or
        None) of a supervised batch: the augment and mixup, drawing from
        ``self.generator`` in that order."""
        labels = _as_tensor(batch["label"], self.device)
        if "raw_video" in batch:
            video = self._augment(_as_tensor(batch["raw_video"], self.device))
        else:
            video = _as_tensor(batch["video"], self.device, torch.float32)
        soft = None
        if self.mixup_fn is not None:
            video, soft = self._mixup(video, labels)
        return video.to(self.dtype), labels, soft

    def _supervised_step(self, batch, lr, wd):
        video, labels, soft = self._train_inputs(batch)
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
        bs = logits.shape[0]
        if self.mesh is not None:  # this rank's share of the global mean
            loss = loss / (self.mesh.data * self.seq_shards)
            bs *= self.mesh.data
        loss.backward()
        correct = topk_correct(logits.detach(), acc_labels)
        if self.mesh is not None:
            loss, (correct[1], correct[5]) = self._reduce_step(
                loss, (correct[1], correct[5]))
        grad_norm = self.optimizer.step(lr, wd)
        return {"loss": loss.detach(), "grad_norm": grad_norm,
                "top1": correct[1], "top5": correct[5], "bs": bs}

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
        mask = _as_tensor(batch["mask"], dev)
        markers = _as_tensor(batch["cube_marker"], dev)
        counts = _as_tensor(batch["cube_count"], dev)
        if "raw_video" in batch:
            video, raw = self._augment(_as_tensor(batch["raw_video"], dev),
                                       mim=True)
        else:
            video = _as_tensor(batch["video"], dev, torch.float32)
            raw = batch.get("raw")
        video = video.to(self.dtype)
        if "hog" in batch:
            target = _as_tensor(batch["hog"], dev, torch.float32)
        else:
            target = self._hog_targets(_as_tensor(raw, dev, torch.float32),
                                       markers, counts)
        self.optimizer.zero_grad()
        self.model.train()
        # under data parallelism this rank's share of the global loss
        _, loss = self.model(video, target, mask, markers, counts,
                             self.generator)
        loss.backward()
        if self.mesh is not None:
            loss, _ = self._reduce_step(loss)
        grad_norm = self.optimizer.step(lr, wd)
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    @torch.no_grad()
    def eval_step(self, batch, n_crops):
        """Top-k counts of ``{"video": (B·n_crops, T, C, H, W), "label":
        (B,)}``, logits averaged over the crops; label -1 rows count
        nowhere. ``{"raw_video": (B, T, H, W, C) uint8, "label"}`` goes
        through the eval recipe on the device first: CenterCrop, or
        ThreeCrop when ``n_crops`` > 1 (trainer.py:443-455). Under data
        parallelism the batch is this rank's rows and so are the counts
        (``_evaluate`` sums them)."""
        if not self.supervised:
            raise ValueError("eval_step needs a supervised run (a mim run "
                             "has no head)")
        if self.mesh is not None:
            batch = self._model_group_batch(batch)
        return self._eval_step(batch, n_crops)

    def _eval_video(self, batch, n_crops):
        """The clips of an eval batch in the working type: ``video`` as it
        is, ``raw_video`` through the eval recipe (trainer.py:443-455)."""
        if "raw_video" not in batch:
            return _as_tensor(batch["video"], self.device, self.dtype)
        cfg = self.configs
        mean, std = dataset_statistics(getattr(cfg, "data_statics",
                                               "kinetics"))
        return eval_preprocess_batch(
            _as_tensor(batch["raw_video"], self.device),
            img_size=cfg.img_size, three_crop=n_crops > 1, mean=mean,
            std=std).to(self.dtype)

    def _eval_counts(self, logits, labels, n_crops):
        """(top-1, top-5, counted rows) of ``logits`` (B·n_crops, C),
        averaged over the crops."""
        if n_crops > 1:
            logits = logits.reshape(-1, n_crops, logits.shape[-1]).mean(dim=1)
        correct = topk_correct(logits, labels)
        return correct[1], correct[5], (labels >= 0).sum()

    def _eval_step(self, batch, n_crops):
        self.model.eval()
        video = self._eval_video(batch, n_crops)
        labels = _as_tensor(batch["label"], self.device)
        top1, top5, bs = self._eval_counts(
            self.cls_head(self._features(video)), labels, n_crops)
        return {"top1": top1, "top5": top5, "bs": bs}

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
        for i, batch in enumerate(device_prefetch(loader, self.device)):
            data_time = time.perf_counter() - data_start
            stats = self.train_step(batch, lr, wd)
            if self.supervised:
                self.train_meter.update({1: stats["top1"], 5: stats["top5"]},
                                        stats["bs"])
            if i % log_interval == 0:
                step_time = time.perf_counter() - data_start
                msg = (f"epoch {self.epoch} step {i}/{len(loader)} loss "
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
            freq = getattr(self.configs, "save_ckpt_freq", 20)
            if not self.supervised and (self.epoch + 1) % freq == 0:
                ts = time.strftime("%Y-%m-%d_%H-%M-%S", time.localtime())
                self.save_checkpoint(osp.join(self.ckpt_dir,
                                              f"{ts}_ep_{self.epoch}"))

    def _evaluate(self, loader, meter, n_crops, what):
        meter.reset()
        for batch in _mesh.even_eval_batches(
                device_prefetch(loader, self.device), self.mesh, self.device,
                n_crops):
            stats = self.eval_step(batch, n_crops)
            meter.update({1: stats["top1"], 5: stats["top5"]}, stats["bs"])
        if self.mesh is not None:  # the data ranks' counts summed
            counts = torch.tensor([meter.correct[1], meter.correct[5],
                                   meter.total], device=self.device)
            dist.all_reduce(counts, group=self.mesh.data_group)
            meter.correct[1], meter.correct[5], meter.total = counts.tolist()
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
        """Parameters, optimizer moments and progress to one file (the keys
        of ``CHECKPOINT_KEYS``). Under a mesh every rank calls it: the
        model group (the pipe group under pipeline parallelism) gathers
        the full state, rank 0 writes it, and every rank waits for the
        file."""
        payload = {"model": self.model_state_dict(),
                   "cls_head": self.head_state_dict(),
                   "opt_state": self._gather_moments(
                       self.optimizer.state_dict()),
                   "epoch": self.epoch + 1,
                   "global_step": self.global_step,
                   "max_top1_acc": self.max_top1_acc}
        if self.is_main:
            os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
            torch.save(payload, path)
        _mesh.barrier(self.mesh)

    def load_checkpoint(self, path):
        """A checkpoint of ``save_checkpoint`` (the full state), this rank's
        shard (or stage) of it under tensor (or pipeline) parallelism."""
        payload = torch.load(path, map_location=self.device,
                             weights_only=True)
        self._set_model_state(payload["model"])
        if self.cls_head is not None:
            self.cls_head.load_state_dict(payload["cls_head"], strict=True)
        self.optimizer.load_state_dict(
            self._local_moments(payload["opt_state"]))
        self.epoch = int(payload["epoch"])
        self.global_step = int(payload["global_step"])
        self.max_top1_acc = float(payload["max_top1_acc"])

    def close(self):
        if self._log_fh is not None:
            self._log_fh.close()
            self._log_fh = None

    def print(self, *args):
        if not self.is_main:
            return
        print(*args, flush=True)
        if self._log_fh is not None:
            print(*args, file=self._log_fh, flush=True)


CHECKPOINT_KEYS = ("model", "cls_head", "opt_state", "epoch", "global_step",
                   "max_top1_acc")


def is_port_checkpoint(payload):
    """Whether ``payload`` (a loaded checkpoint) is one that
    ``VideoTransformerTrainer.save_checkpoint`` wrote."""
    return isinstance(payload, dict) and set(CHECKPOINT_KEYS) <= set(payload)


def _now():
    return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime())
