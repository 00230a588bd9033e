"""Entry points of the port: the flagship forward and a
multi-process dry run of the parallel train steps.

Twin of the JAX package's ``__graft_entry__.py`` (:31-52, :129-258):

- ``entry(device="cuda")`` returns ``(fn, args)``: TimeSformer-B/16's
  divided space-time forward from a (1, 8, 3, 224, 224) clip to 400
  logits, random weights from seed 0, ``fn(*args)`` the logits. On a card
  the model runs in bf16 (the kernels' type), on the CPU in fp32;
- ``dryrun_multichip(n, device="cuda")`` starts ``n`` ranks over gloo
  (sharing the one card, or on the CPU when asked) and runs one supervised
  step, mixup on, on a dp x sp x tp mesh chosen as JAX chooses it (tp 2
  from 4 ranks on, sp 2 from 8 on), and with n >= 4 one step on dp(n/2) x
  pp2 (``training/pp_trainer.py``); rank 0 holds each against the same
  global batch in one process, the loss within 1e-4 and the grad norm
  within 1e-3 of max(1, |one process's|) (JAX's bounds, for its fp32
  run), and prints JAX's line, ending in ``OK``. The dry run's model is
  JAX's tiny TimeSformer (2 frames at 32², 4 heads, 2 layers, 10 classes,
  DropPath 0) at width 32 on the CPU, in fp32. The card's kernels take
  widths that are multiples of 64 and bf16 only, and a tp = 2 shard of
  width 64 would be 32 wide: on the card the model is 128 wide (head dim
  32, the tp shard 64 wide) and computes in bf16 with fp32 parameters.
  There a tp shard's partial projection is rounded to bf16 before the
  shards' sum, where one process rounds the whole sum once: the loss
  parts by about 2e-4 of itself (measured on an H100), so on the card the
  loss is held within 1e-3 (the grad norm within JAX's 1e-3). A sharding
  fault moves either by far more. Before JAX's line rank 0 prints each
  leg's relative differences from one process beside the bounds.

    python -m videotransformer_tpu_torch.graft_entry [multichip N]
        [--device cpu]
"""

import argparse
import os
import subprocess
import sys
import tempfile
from types import SimpleNamespace

import numpy as np
import torch

DRYRUN_TIMEOUT_S = 600
# the loss against one process's: JAX's bound in fp32 on the CPU, bf16's
# on the card (module doc)
LOSS_TOL = {"cpu": 1e-4, "cuda": 1e-3}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def entry(device="cuda"):
    """(fn, args): ``fn(*args)`` is TimeSformer-B/16's divided forward of a
    zero clip (1, 8, 3, 224, 224) to (1, 400) logits (module doc)."""
    from videotransformer_tpu_torch.models.timesformer import (
        get_vit_base_patch16_224)
    from videotransformer_tpu_torch.ops.blocks import ClassificationHead
    from videotransformer_tpu_torch.utils.helpers import resolve_device

    dev = resolve_device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    model = get_vit_base_patch16_224(num_frames=8)
    head = ClassificationHead(400, 768)
    g = torch.Generator().manual_seed(0)
    model.reset_parameters(g)
    head.reset_parameters(g)
    model = model.to(dev, dtype).eval()
    head = head.to(dev, dtype).eval()
    video = torch.zeros((1, 8, 3, 224, 224), dtype=dtype, device=dev)

    @torch.inference_mode()
    def fn(model, head, video):
        return head(model(video))

    return fn, (model, head, video)


def dryrun_multichip(n_devices, device="cuda", timeout_s=DRYRUN_TIMEOUT_S):
    """Run the dry run (module doc) in ``n_devices`` processes meeting in a
    FileStore, each killed after ``timeout_s``; write rank 0's output to
    stdout and raise if a rank failed or rank 0 printed no ``OK``."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip(device='cuda') needs a card; "
                           "pass device='cpu' for the CPU")
    with tempfile.TemporaryDirectory(prefix="vt_dryrun_") as tmp:
        store = f"file://{os.path.join(tmp, 'store')}"
        procs = [subprocess.Popen(
            [sys.executable, "-m", "videotransformer_tpu_torch.graft_entry",
             "rank", str(r), str(n_devices), store, "--device", device],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, start_new_session=True) for r in range(n_devices)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout_s)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    sys.stdout.write(outs[0])
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed or "OK" not in outs[0]:
        raise RuntimeError(f"dryrun_multichip({n_devices}) ranks {failed} "
                           f"failed:\n" + "\n".join(o[-2000:] for o in outs))


def _configs(n_devices, device):
    """JAX's dry-run configuration (``__graft_entry__.py:150-155``)."""
    return SimpleNamespace(
        objective="supervised", arch="timesformer",
        attention_type="divided_space_time", num_class=10, num_frames=2,
        img_size=32, batch_size=n_devices, num_workers=1, optim_type="adamw",
        lr=1e-3, lr_schedule="cosine", warmup_epochs=1, min_lr=1e-6,
        weight_decay=0.05, weight_decay_end=0.05, clip_grad=1.0, seed=0,
        mixup=True, eval_metrics="finetune", layer_decay=1.0,
        drop_path_rate=0.0, use_fp16=device.type == "cuda", tp=1, sp=1, pp=1,
        pp_microbatch=0)


def _tiny_build(width):
    """The dry run's one model build, for every trainer it compares."""
    from videotransformer_tpu_torch.models.timesformer import TimeSformer

    def build(c, mesh=None):
        return TimeSformer(num_frames=c.num_frames, img_size=c.img_size,
                           patch_size=16, embed_dims=width, num_heads=4,
                           num_transformer_layers=2,
                           attention_type=c.attention_type,
                           drop_path_rate=0.0, mesh=mesh)

    return build


def _rank(rank, n_devices, store, device):
    """One rank of the dry run; rank 0 checks and prints."""
    from videotransformer_tpu_torch.parallel import mesh as _mesh
    from videotransformer_tpu_torch.training import pp_trainer
    from videotransformer_tpu_torch.training import trainer as trainer_mod

    dev = _mesh.init_distributed("gloo", store, rank, n_devices, device)
    trainer_mod.build_model = _tiny_build(128 if dev.type == "cuda" else 32)
    model_axis = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    seq_axis = 2 if n_devices % (2 * model_axis) == 0 and n_devices >= 8 \
        else 1
    cfg = _configs(n_devices, dev)
    rng = np.random.RandomState(0)
    host = {"video": rng.rand(2 * n_devices, 2, 3, 32, 32).astype(np.float32),
            "label": (np.arange(2 * n_devices) % 10).astype(np.int32)}
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}

    def step(tr, mesh):
        stats = tr.train_step(_mesh.shard_batch(mesh, batch), 1e-3, 0.05)
        return float(stats["loss"]), float(stats["grad_norm"])

    mesh = _mesh.create_mesh(data=n_devices // (model_axis * seq_axis),
                             seq=seq_axis, model=model_axis, device=dev)
    loss, gnorm = step(trainer_mod.VideoTransformerTrainer(
        SimpleNamespace(**{**vars(cfg), "tp": model_axis, "sp": seq_axis}),
        dev, mesh=mesh), mesh)
    pp_note, pp_stats = "", None
    if n_devices >= 4:
        cfg_pp = SimpleNamespace(**{**vars(cfg), "pp": 2})
        pp_mesh = _mesh.create_mesh(data=n_devices // 2, pipe=2, device=dev)
        pp_stats = step(pp_trainer.PipelineTrainer(cfg_pp, dev, mesh=pp_mesh),
                        pp_mesh)
        pp_note = (f" dp{n_devices // 2}xpp2 train loss={pp_stats[0]:.4f} "
                   f"grad_norm={pp_stats[1]:.4f}")
    if rank == 0:
        # the same global batch through the same trainer in one process
        loss1, gnorm1 = step(trainer_mod.VideoTransformerTrainer(cfg, dev),
                             None)
        loss_tol = LOSS_TOL[dev.type]
        runs = [(what, v) for what, v in (("dp x sp x tp", (loss, gnorm)),
                                          ("dp x pp", pp_stats)) if v]
        rel = lambda a, b: abs(a - b) / max(1.0, abs(b))
        print("dryrun_multichip against one process (loss, grad_norm): "
              + "; ".join(f"{what} {rel(l, loss1):.3e} {rel(g, gnorm1):.3e}"
                          for what, (l, g) in runs)
              + f" (bounds {loss_tol:g} {1e-3:g})", flush=True)
        for what, (l, g) in runs:
            if not (np.isfinite(l) and abs(l - loss1)
                    < loss_tol * max(1.0, abs(loss1))
                    and abs(g - gnorm1) < 1e-3 * max(1.0, abs(gnorm1))):
                raise AssertionError(f"{what}: loss {l} grad_norm {g}, one "
                                     f"process {loss1} {gnorm1}")
        print(f"dryrun_multichip({n_devices}) mesh=dp{mesh.data}"
              f"xsp{mesh.seq}xtp{mesh.model}: loss={loss:.4f} "
              f"grad_norm={gnorm:.4f} (1-device check: loss={loss1:.4f} "
              f"grad_norm={gnorm1:.4f}){pp_note} OK", flush=True)
    torch.distributed.destroy_process_group()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("what", nargs="?", default="entry",
                   choices=("entry", "multichip", "rank"))
    p.add_argument("numbers", nargs="*")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.what == "rank":
        rank, n, store = args.numbers
        _rank(int(rank), int(n), store, args.device)
    elif args.what == "multichip":
        dryrun_multichip(int(args.numbers[0]) if args.numbers else 8,
                         args.device)
    else:
        fn, fn_args = entry(args.device)
        out = fn(*fn_args)
        print("entry OK:", tuple(out.shape), out.dtype)


if __name__ == "__main__":
    main()
