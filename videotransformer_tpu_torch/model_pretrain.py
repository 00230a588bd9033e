"""The training CLI of the port, flag for flag the JAX package's
``model_pretrain.py`` (the reference's model_pretrain.py:21-230):

    python -m videotransformer_tpu_torch.model_pretrain -epoch 1 \\
        -batch_size 8 -num_class 400 -num_frames 8 -frame_interval 32 \\
        -objective supervised -arch timesformer -lr 0.005 \\
        -root_dir WORK -train_data_path TRAIN.txt [-val_data_path ...] \\
        [-device_augment True] [-device cpu]

Under torchrun (``torchrun --nproc_per_node N -m
videotransformer_tpu_torch.model_pretrain ... [-tp T]``) each process joins
the process group (``parallel/mesh.init_distributed``: NCCL on
``cuda:LOCAL_RANK``, gloo with ``-device cpu``) and trains on a (data =
N / T, model = T) mesh: data parallelism over N / T ranks, Megatron tensor
parallelism of the blocks over T (``-batch_size`` clips a data rank).

``single_run`` validates ``-tp``/``-sp`` as the JAX CLI does
(``validate_parallel_flags``), scales the LR by the global batch over 256
(the data ranks' batches only, JAX model_pretrain.py:237-241), names the
run's results/{tag}/{ckpt,log} directories by the same tag (a long tag is
cut with a hash), seeds numpy, ``random``, the transforms' generator and
torch, builds the ``KineticsDataModule`` over the data rank's shard,
resumes from ``last_checkpoint`` with ``-resume``, and fits.

Differences from the JAX CLI, on purpose:

- ``-device`` (default ``cuda``): the card, or ``cpu``.
- Flags of ``type=bool`` in the JAX CLI parse by value here: ``-use_fp16
  False`` is False. argparse's ``type=bool`` makes any non-empty string
  True, so the JAX CLI (and the reference) read ``False`` as True.
- Flags the port cannot honour raise ``NotImplementedError``: ``-sp`` or
  ``-pp`` above 1 (sequence and pipeline parallelism, the rest of ROADMAP
  queue A item A11) and ``-scan_layers True`` (not ported: a lax.scan
  layout). ``-remat True`` checkpoints every TimeSformer or ViViT block
  (MaskFeat ignores it, as in JAX). ``-fused_adamw`` only changes how the
  JAX optimizer lays out its small leaves, and ``-gpus`` and
  ``-multi_crop`` are read by neither trainer.
"""

import argparse
import hashlib
import os
import random
import time

import numpy as np


def str_to_bool(text):
    """'True'/'False' (and 1/0, yes/no, t/f, y/n, any case) -> bool."""
    low = str(text).strip().lower()
    if low in ("true", "1", "yes", "y", "t"):
        return True
    if low in ("false", "0", "no", "n", "f"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {text!r}")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="lr receiver")
    # Common
    parser.add_argument("-epoch", type=int, required=True,
                        help="the max epochs of training")
    parser.add_argument("-batch_size", type=int, required=True,
                        help="the batch size of data inputs")
    parser.add_argument("-num_workers", type=int, default=4,
                        help="the num workers of loading data")
    parser.add_argument("-resume", default=False, action="store_true")
    parser.add_argument("-resume_from_checkpoint", type=str, default=None,
                        help="the pretrain params from specific path")
    parser.add_argument("-log_interval", type=int, default=30,
                        help="the intervals of logging")
    parser.add_argument("-save_ckpt_freq", type=int, default=20,
                        help="the intervals of saving model")
    parser.add_argument("-objective", type=str, default="mim",
                        help="the learning objective from [mim, supervised]")
    parser.add_argument("-eval_metrics", type=str, default="finetune",
                        help="the eval metrics choosen from [linear_prob, "
                             "finetune]")

    # Environment
    parser.add_argument("-gpus", nargs="+", type=int, default=-1,
                        help="kept for compatibility; the device is -device")
    parser.add_argument("-device", type=str, default="cuda",
                        help="torch device to train on: cuda or cpu")
    parser.add_argument("-root_dir", type=str, required=True,
                        help="the path to root dir for work space")

    # Data
    parser.add_argument("-num_class", type=int, required=True)
    parser.add_argument("-num_samples_per_cls", type=int, default=10000)
    parser.add_argument("-img_size", type=int, default=224)
    parser.add_argument("-num_frames", type=int, required=True)
    parser.add_argument("-frame_interval", type=int, required=True)
    parser.add_argument("-data_statics", type=str, default="kinetics",
                        help="choose data statics from [imagenet, kinetics]")
    parser.add_argument("-train_data_path", type=str, required=True)
    parser.add_argument("-val_data_path", type=str, default=None)
    parser.add_argument("-test_data_path", type=str, default=None)
    parser.add_argument("-multi_crop", type=str_to_bool, default=False)
    parser.add_argument("-mixup", type=str_to_bool, default=False)
    parser.add_argument("-auto_augment", type=str, default=None)

    # Model
    parser.add_argument("-arch", type=str, default="timesformer",
                        help="the choosen model arch from [timesformer, "
                             "vivit, mvit]")
    parser.add_argument("-attention_type", type=str,
                        default="divided_space_time")
    parser.add_argument("-pretrain_pth", type=str, default=None)
    parser.add_argument("-weights_from", type=str, default="imagenet",
                        help="the pretrain params from [imagenet, kinetics]")

    # Training/Optimization parameters
    parser.add_argument("-seed", type=int, default=0)
    parser.add_argument("-optim_type", type=str, default="adamw")
    parser.add_argument("-lr_schedule", type=str, default="cosine")
    parser.add_argument("-lr", type=float, required=True)
    parser.add_argument("-layer_decay", type=float, default=0.75)
    parser.add_argument("--min_lr", type=float, default=1e-6)
    parser.add_argument("-use_fp16", type=str_to_bool, default=True,
                        help="bf16 compute with fp32 parameters")
    parser.add_argument("-weight_decay", type=float, default=0.05)
    parser.add_argument("-weight_decay_end", type=float, default=0.05)
    parser.add_argument("-clip_grad", type=float, default=0)
    parser.add_argument("-warmup_epochs", default=5, type=int)

    # the JAX package's additions
    parser.add_argument("-device_augment", type=str_to_bool, default=False,
                        help="decode fixed-size uint8 clips and run the "
                             "train augment (and the eval recipe) on the "
                             "device")
    parser.add_argument("-device_hog", type=str_to_bool, default=False,
                        help="mim only: compute HOG targets on the device "
                             "(implied by -device_augment)")
    parser.add_argument("-aug_scale", type=float, nargs=2,
                        default=[0.08, 1.0],
                        help="RandomResizedCrop area range of the device "
                             "augment")
    parser.add_argument("-aug_hflip", type=float, default=0.5,
                        help="horizontal-flip probability (device augment)")
    parser.add_argument("-aug_color", type=float, nargs=4,
                        default=[0.4, 0.4, 0.4, 0.0],
                        help="brightness/contrast/saturation/hue jitter "
                             "strengths (device augment)")
    parser.add_argument("-classmap_path", type=str, default=None,
                        help="custom classmap json (defaults to the bundled "
                             "k400/k600 maps by num_class)")
    parser.add_argument("-video_root", type=str, default=None,
                        help="root dir for relative annotation rows "
                             "(default: the annotation file's directory)")
    parser.add_argument("-remat", type=str_to_bool, default=False,
                        help="activation checkpointing of every "
                             "TimeSformer/ViViT block (torch.utils."
                             "checkpoint)")
    parser.add_argument("-fused_adamw", type=str_to_bool, default=True,
                        help="the JAX optimizer's flat small-leaf layout; "
                             "the port's AdamW is per tensor")
    parser.add_argument("-tp", type=int, default=1,
                        help="tensor-parallel size (Megatron over the "
                             "attention heads and FFN hidden units)")
    parser.add_argument("-sp", type=int, default=1,
                        help="sequence-parallel size (not ported)")
    parser.add_argument("-pp", type=int, default=1,
                        help="pipeline-parallel stages (not ported)")
    parser.add_argument("-pp_microbatch", type=int, default=0,
                        help="GPipe microbatches per step (not ported)")
    parser.add_argument("-scan_layers", type=str_to_bool, default=False,
                        help="the JAX package's lax.scan layer stack (not "
                             "ported)")
    return parser.parse_args(argv)


def validate_parallel_flags(args):
    """Fail fast on -tp/-sp values the model geometry can't shard (JAX
    model_pretrain.py:170-195, the same checks and messages): MViT under
    -tp, a -tp that does not divide the 12 heads of the B/16 builders, and
    a -sp that is not over divided attention rows or does not divide both
    the (effective) frame and the patch count."""
    from videotransformer_tpu_torch.parallel import tp as _tp

    tp, sp = getattr(args, "tp", 1), getattr(args, "sp", 1)
    try:
        _tp.validate(args.arch, tp)
    except ValueError as exc:
        raise SystemExit(str(exc)) from None
    if sp > 1:
        if args.attention_type not in ("divided_space_time", "fact_encoder"):
            raise SystemExit(
                f"-sp > 1 requires divided attention rows "
                f"(attention_type divided_space_time/fact_encoder), got "
                f"{args.attention_type}")
        frames = args.num_frames // 2 if args.arch == "vivit" \
            else args.num_frames
        patches = (args.img_size // 16) ** 2
        if frames % sp or patches % sp:
            raise SystemExit(
                f"-sp {sp} must divide both the (effective) frame count "
                f"({frames}) and the patch count ({patches}); a "
                f"non-divisible sp falls back to unsharded attention rows.")


def refuse_unported(args):
    """Raise NotImplementedError for flags the port cannot honour."""
    for flag, what in (("sp", "sequence"), ("pp", "pipeline")):
        if getattr(args, flag) > 1:
            raise NotImplementedError(
                f"-{flag} {getattr(args, flag)}: {what} parallelism is not "
                "ported (the rest of ROADMAP queue A, item A11); the port "
                "has data parallelism (torchrun) and -tp")
    if args.scan_layers:
        raise NotImplementedError(
            "-scan_layers True: the lax.scan layer stack is not ported "
            "(ROADMAP 'Do not port')")


def resolve_resume_checkpoint(ckpt_dir):
    """``-resume`` reads ckpt_dir/last_checkpoint (model_pretrain.py:
    190-192), else the newest checkpoint file in ckpt_dir."""
    last = os.path.join(ckpt_dir, "last_checkpoint")
    if os.path.exists(last) or not os.path.isdir(ckpt_dir):
        return last
    files = [os.path.join(ckpt_dir, f) for f in os.listdir(ckpt_dir)]
    files = [f for f in files if os.path.isfile(f)]
    return max(files, key=os.path.getmtime) if files else last


def exp_tag(args):
    """The run's directory name (model_pretrain.py:244-260); a tag over
    200 characters keeps 188 and a hash of the whole."""
    tag = (
        f"objective_{args.objective}_arch_{args.arch}_lr_{args.lr}_"
        f"optim_{args.optim_type}_lr_schedule_{args.lr_schedule}_"
        f"fp16_{args.use_fp16}_weight_decay_{args.weight_decay}_"
        f"weight_decay_end_{args.weight_decay_end}_warmup_epochs_"
        f"{args.warmup_epochs}_pretrain_{args.pretrain_pth}_weights_from_"
        f"{args.weights_from}_seed_{args.seed}_img_size_{args.img_size}_"
        f"num_frames_{args.num_frames}_eval_metrics_{args.eval_metrics}_"
        f"frame_interval_{args.frame_interval}_mixup_{args.mixup}_"
        f"multi_crop_{args.multi_crop}_auto_augment_{args.auto_augment}_")
    if len(tag) > 200:
        digest = hashlib.sha1(tag.encode()).hexdigest()[:10]
        tag = tag[:188] + "_" + digest
    return tag


def single_run(argv=None):
    args = parse_args(argv)
    validate_parallel_flags(args)
    refuse_unported(args)

    import torch

    from videotransformer_tpu_torch.data import transforms as T
    from videotransformer_tpu_torch.parallel import mesh as _mesh
    from videotransformer_tpu_torch.training.data_module import (
        KineticsDataModule)
    from videotransformer_tpu_torch.training.trainer import (
        VideoTransformerTrainer)

    # under torchrun: the process group, this rank's card, the mesh
    device = _mesh.init_distributed(device=args.device)
    mesh = None
    world = 1
    if torch.distributed.is_initialized():
        world = torch.distributed.get_world_size()
        mesh = _mesh.create_mesh(model=args.tp, device=device)
    elif args.tp > 1:
        raise SystemExit(f"-tp {args.tp} needs {args.tp} processes or more "
                         "(torchrun --nproc_per_node)")
    # linear LR scale by the global batch over 256 (model_pretrain.py:
    # 158-164): the data-parallel ranks' batches only, as tensor-parallel
    # ranks share one (JAX model_pretrain.py:237-241)
    args.lr = args.lr * args.batch_size * (world // args.tp) / 256
    run_dir = os.path.join(args.root_dir, "results", exp_tag(args))
    ckpt_dir = os.path.join(run_dir, "ckpt")
    log_dir = os.path.join(run_dir, "log")
    os.makedirs(ckpt_dir, exist_ok=True)
    os.makedirs(log_dir, exist_ok=True)

    # reproducible (model_pretrain.py:215-219)
    np.random.seed(args.seed)
    random.seed(args.seed)
    T.seed_transforms(args.seed)
    torch.manual_seed(args.seed)

    data_module = KineticsDataModule(
        configs=args, train_ann_path=args.train_data_path,
        val_ann_path=args.val_data_path, test_ann_path=args.test_data_path,
        process_index=0 if mesh is None else mesh.data_rank,
        num_processes=1 if mesh is None else mesh.data)
    if args.resume and not args.resume_from_checkpoint:
        args.resume_from_checkpoint = resolve_resume_checkpoint(ckpt_dir)
    trainer = VideoTransformerTrainer(
        configs=args, device=device, ckpt_dir=ckpt_dir,
        do_eval=args.val_data_path is not None,
        do_test=args.test_data_path is not None, log_dir=log_dir, mesh=mesh)
    try:
        resume = args.resume_from_checkpoint
        if resume and os.path.exists(resume):
            trainer.print(f"resuming from {resume}")
            trainer.load_checkpoint(resume)
        trainer.print(args)
        ts = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime())
        trainer.print(f"{ts} - INFO - Start running,")
        trainer.fit(data_module, args.epoch)
    finally:
        trainer.close()
        if mesh is not None:
            torch.distributed.destroy_process_group()
    return trainer


if __name__ == "__main__":
    single_run()
