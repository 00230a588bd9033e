"""One rank of a data- or tensor-parallel training run of a few steps.

    python -m videotransformer_tpu_torch.tools.mp_train_worker \\
        --rank R --world W --init file:///path/to/store [--tp T] \\
        [--model b16|tiny] [--device cuda|cpu] [--backend nccl|gloo] ...

(or under torchrun, which sets the rank and world). TimeSformer-B on the
rank's card by default. Each rank builds the same trainer on a (data =
W / T, model = T) mesh, takes its rows of a global batch made from a seed
with numpy (``mesh.shard_batch``), and trains ``--steps`` steps; then it
runs the trainer's ``fit`` for one epoch over a data module of one more
step on the same batch and of ``--eval_clips`` validation and three-crop
test clips, read by ``Loader``s of the rank's data shard in batches of
``--eval_batch`` (a set that does not divide by the data ranks gives them
shards of different sizes, which the trainer's eval pads), and gathers
the parameters. It prints, for the caller to hold against the same
``run`` in one process on the global batch:

    STEP i loss L grad_norm G ms T device_ms E
    VAL top1 A top5 B
    TEST top1 A top5 B
    DIGEST <sha256 of the gathered parameters' bytes>
    LAUNCHES {"fused_prenorm_mhsa": n, ..., "attention": {...}, ...}

(a step's host-clock and CUDA-event ms on the card, the host clock's on
the CPU, where device_ms is 0; the kernels' launches and B1's and B3's by
attention variant) and, with ``--ckpt PREFIX``, rank 0 writes the gathered
checkpoint after step i to PREFIX.i (``save_checkpoint``'s format). The twin of the JAX package's
tests/mp_train_worker.py.

Models: ``b16``, TimeSformer-B/16 (8 x 224, 12 layers, 400 classes), the
trainer's own build; ``tiny``, a TimeSformer of 2 layers, width 64, 4
heads, 2 frames at 32² (the CPU tests, with ``--device cpu``; ``--arch
vivit``: a ViViT of the same width at 4 frames, tube 2, with 2 temporal
layers for ``fact_encoder``; ``--objective mim``: a MaskFeat of depth 4 at
4 frames of 32², DP only, no eval); ``--attention_type`` as the trainer
takes it. ``--remat`` checkpoints every block (``-remat True``); under
``--tp`` each block's second forward in the backward runs its model-group
all-reduces again.
"""

import argparse
import hashlib
import json
import time
from types import SimpleNamespace

import numpy as np
import torch

from videotransformer_tpu_torch.data.pipeline import (
    Loader, collate_supervised)
from videotransformer_tpu_torch.kernels import (
    flash_attention, fused_ffn, fused_mhsa)
from videotransformer_tpu_torch.models.convert import flatten_tree
from videotransformer_tpu_torch.parallel import mesh as _mesh
from videotransformer_tpu_torch.training import trainer as trainer_mod
from videotransformer_tpu_torch.training.data_module import ThreeCropCollate

SEED, WD = 0, 0.05
TINY = dict(img_size=32, patch_size=16, embed_dims=64, num_heads=4,
            num_transformer_layers=2)
TINY_MIM = dict(depth=4, embed_dim_mul=((1, 2.0), (3, 2.0)),
                atten_head_mul=((1, 2.0), (3, 2.0)),
                pool_q_stride_size=((1, 1, 2, 2), (3, 1, 2, 2)),
                feature_dim=2 * 2 * 2 * 3 * 9)
KERNEL_COUNTERS = {"fused_prenorm_mhsa": (fused_mhsa, "LAUNCHES"),
                   "fused_prenorm_ffn": (fused_ffn, "LAUNCHES"),
                   "fused_prenorm_mhsa_bwd": (fused_mhsa, "BWD_LAUNCHES"),
                   "fused_prenorm_ffn_bwd": (fused_ffn, "BWD_LAUNCHES"),
                   "flash_attention": (flash_attention, "LAUNCHES"),
                   "flash_attention_bwd": (flash_attention, "BWD_LAUNCHES")}


def launches():
    counts = {n: getattr(mod, attr)
              for n, (mod, attr) in KERNEL_COUNTERS.items()}
    counts["attention"] = dict(fused_mhsa.ATTENTION_LAUNCHES)
    counts["attention_bwd"] = dict(fused_mhsa.ATTENTION_BWD_LAUNCHES)
    return counts


def timed_step(tr, batch, lr, wd):
    """(stats, host ms, device ms) of one train step, synchronised on a
    card (the device ms from CUDA events around it; 0 on the CPU)."""
    cuda = tr.device.type == "cuda"
    if cuda:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        torch.cuda.synchronize(tr.device)
        start.record()
    t0 = time.perf_counter()
    stats = tr.train_step(batch, lr, wd)
    if cuda:
        end.record()
        end.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return stats, ms, start.elapsed_time(end) if cuda else 0.0


def configs(args):
    """The JAX trainer's defaults for the run: AdamW (or ``--optim sgd``),
    per-parameter clip 1.0; ``b16`` in bf16 compute with fp32
    parameters; ``fit``'s one epoch at ``--lr`` (its one warmup epoch
    ends there)."""
    b16 = args.model == "b16"
    mim = args.objective == "mim"
    frames = 4 if mim or args.arch == "vivit" else 2  # tiny: ViViT's tube 2
    return SimpleNamespace(
        objective=args.objective, arch="mvit" if mim else args.arch,
        attention_type=args.attention_type,
        num_class=400 if b16 else 10, num_frames=8 if b16 else frames,
        img_size=224 if b16 else 32, optim_type=args.optim, clip_grad=1.0,
        seed=SEED, mixup=args.mixup, eval_metrics="finetune",
        use_fp16=b16, drop_path_rate=args.drop_path, layer_decay=1.0,
        weight_decay=WD, lr=args.lr, warmup_epochs=1, remat=args.remat)


def use_tiny_models(objective):
    """Point the trainer's ``build_model`` at the tiny models."""
    from videotransformer_tpu_torch.models.maskfeat import MaskFeat
    from videotransformer_tpu_torch.models.timesformer import TimeSformer
    from videotransformer_tpu_torch.models.vivit import ViViT

    def build(c, mesh=None):
        if objective == "mim":
            return MaskFeat(img_size=c.img_size, num_frames=c.num_frames,
                            mesh=mesh, **TINY_MIM)
        extra = {"num_time_transformer_layers": 2} if c.arch == "vivit" \
            else {}
        return {"timesformer": TimeSformer, "vivit": ViViT}[c.arch](
            num_frames=c.num_frames, attention_type=c.attention_type,
            drop_path_rate=c.drop_path_rate, mesh=mesh, remat=c.remat,
            **TINY, **extra)

    trainer_mod.build_model = build


def global_batch(cfg, clips, seed):
    """The global train batch, from ``seed`` with numpy. mim: host HOG
    targets and cube masks whose counts differ from clip to clip (the
    first half of the clips masked far more than the second)."""
    rng = np.random.RandomState(seed)
    t, s = cfg.num_frames, cfg.img_size
    video = rng.standard_normal((clips, t, 3, s, s)).astype(np.float32)
    if cfg.objective != "mim":
        return {"video": video,
                "label": rng.randint(0, cfg.num_class, clips).astype(
                    np.int32)}
    h = s // 16
    keep = np.where(np.arange(clips) < clips // 2, 0.2, 0.8)
    mask = (rng.rand(clips, t // 2, h, h) > keep[:, None, None, None])
    markers = np.zeros((clips, 8, 2), np.int32)
    markers[:, 0] = [0, 1]
    markers[:, 1] = [1, 1]
    return {"video": video, "mask": mask.astype(np.int32),
            "cube_marker": markers,
            "cube_count": np.full((clips,), 2, np.int32),
            "hog": rng.rand(clips, t, h, h, 108).astype(np.float32)}


def eval_sets(cfg, clips, seed):
    """(val samples (clip, label), three-crop test samples ((3, T, C, S, S)
    crops, label)) of ``clips`` clips."""
    rng = np.random.RandomState(seed + 1)
    t, s = cfg.num_frames, cfg.img_size
    video = rng.standard_normal((clips, t, 3, s, s)).astype(np.float32)
    labels = (np.arange(clips) % cfg.num_class).astype(np.int32)
    crops = np.stack([video, video * 0.9, video * 1.1], axis=1)
    return list(zip(video, labels)), list(zip(crops, labels))


def data_module(batch, args, cfg, mesh):
    """``fit``'s data: ``batch`` (this rank's train rows) once, and the
    eval sets through ``Loader``s of this rank's data shard."""
    val, test = eval_sets(cfg, args.eval_clips, SEED)
    shard = {} if mesh is None else {"process_index": mesh.data_rank,
                                     "num_processes": mesh.data}
    loader = lambda samples, collate: Loader(
        samples, args.eval_batch, num_workers=1, collate_fn=collate,
        **shard)
    return SimpleNamespace(
        train_loader=lambda: [batch],
        val_loader=lambda: loader(val, collate_supervised),
        test_loader=lambda: loader(test, ThreeCropCollate()))


def digest(tree):
    flat = flatten_tree(tree)
    h = hashlib.sha256()
    for k in sorted(flat):
        h.update(k.encode())
        h.update(np.ascontiguousarray(flat[k]).tobytes())
    return h.hexdigest()


def run(args, device, mesh=None, out=print, params=None, on_step=None):
    """Train, evaluate and gather as the module doc says; ``out`` gets each
    line, ``on_step(i, trainer)`` is called after step i. ``params``: a JAX
    trainer's tree to start from (the seed's initialisation otherwise).
    Returns the trainer."""
    cfg = configs(args)
    tr = trainer_mod.VideoTransformerTrainer(
        cfg, device, do_eval=True, do_test=True, mesh=mesh, params=params)
    rows = _mesh.shard_batch(mesh, global_batch(cfg, args.clips, SEED))
    local = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
             for k, v in rows.items()}
    for i in range(args.steps):
        stats, ms, device_ms = timed_step(tr, local, args.lr, WD)
        out(f"STEP {i} loss {float(stats['loss']):.10e} grad_norm "
            f"{float(stats['grad_norm']):.10e} ms {ms:.3f} device_ms "
            f"{device_ms:.3f}")
        if on_step is not None:
            on_step(i, tr)
    if cfg.objective != "mim" and args.eval_clips:
        tr.fit(data_module(rows, args, cfg, mesh), max_epochs=1)
        for what, meter in (("VAL", tr.val_meter), ("TEST", tr.test_meter)):
            out(f"{what} top1 {meter.compute(1):.10e} top5 "
                f"{meter.compute(5):.10e}")
    tree = tr.params_tree()
    out(f"DIGEST {digest(tree)}")
    return tr


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--world", type=int, default=None)
    p.add_argument("--init", default=None,
                   help="init_method of the process group (file://...); "
                        "torchrun's env:// by default")
    p.add_argument("--backend", default=None, help="gloo or nccl")
    p.add_argument("--device", default="cuda")
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--model", choices=("b16", "tiny"), default="b16")
    p.add_argument("--objective", choices=("supervised", "mim"),
                   default="supervised")
    p.add_argument("--arch", choices=("timesformer", "vivit"),
                   default="timesformer")
    p.add_argument("--attention_type", default="divided_space_time")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--clips", type=int, default=4,
                   help="clips of the global train batch")
    p.add_argument("--eval_clips", type=int, default=3,
                   help="clips of the val and test sets (0: no fit)")
    p.add_argument("--eval_batch", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--optim", choices=("adamw", "sgd"), default="adamw")
    p.add_argument("--mixup", action="store_true")
    p.add_argument("--drop_path", type=float, default=0.0)
    p.add_argument("--remat", action="store_true",
                   help="checkpoint every block (-remat True)")
    p.add_argument("--ckpt", default=None,
                   help="rank 0 writes the gathered checkpoint after step i "
                        "to CKPT.i")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.model == "tiny":
        use_tiny_models(args.objective)
    device = _mesh.init_distributed(
        backend=args.backend, init_method=args.init, rank=args.rank,
        world_size=args.world, device=args.device)
    mesh = _mesh.create_mesh(model=args.tp, device=device)
    save = None if args.ckpt is None else \
        lambda i, tr: tr.save_checkpoint(f"{args.ckpt}.{i}")
    try:
        run(args, device, mesh, out=lambda line: print(line, flush=True),
            on_step=save)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        print(f"LAUNCHES {json.dumps(launches())}", flush=True)
        print("WORKER OK", flush=True)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
