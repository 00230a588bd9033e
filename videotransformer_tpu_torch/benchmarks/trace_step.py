"""Trace a few train steps (or inference forwards) of the port under
torch.profiler and print the device time by category.

Twin of ``benchmarks/trace_step.py``. Configs:

- ``finetune``: the supervised TimeSformer-B 8x224 step of the trainer
  (``train_step``) from uint8 clips, with the device augment, mixup, bf16
  compute and AdamW, as JAX :97-108 takes it;
- ``maskfeat``: the MaskFeat step on MViT-B 16x224, the HOG targets
  computed on the device (JAX :83-96); it prints which cuDNN algorithms it
  ran with (``torch.backends.cudnn.deterministic``: deterministic or the
  default ones);
- ``inference``: the TimeSformer-B 8x224 forward and head over 4 batches
  (JAX's ``lax.scan`` becomes a host loop).

Two steps run before the trace. It prints the wall ms per step (the host
clock to a synchronize), the CUDA-event ms per step of the traced steps,
then ``utils/profiling.py::analyze`` (device ms per step by category, the
top ops, the busy and idle share of the device span), and a JSON line
with the host's share of the step: 1 - busy ms / wall ms, where busy is
the time in which some kernel runs (the summed kernel time counts
kernels on concurrent streams twice). On a card it also prints the
host's top-level CPU ops per step (``analyze`` of the trace's CPU side:
where the host's time goes).

    python -m videotransformer_tpu_torch.benchmarks.trace_step \\
        [--config finetune|maskfeat|inference] [--batch 8] [--steps 3] \\
        [--trace_dir DIR] [--analyze_only] [--device cpu --model tiny]
"""

import argparse
import os
import time

import numpy as np
import torch

from videotransformer_tpu_torch.benchmarks import common
from videotransformer_tpu_torch.training.trainer import (
    VideoTransformerTrainer)
from videotransformer_tpu_torch.utils import profiling
from videotransformer_tpu_torch.utils.helpers import resolve_device

WD = 0.05


def build_step(config, model, batch_size, device):
    """The callable of one step of ``config``."""
    rng = np.random.RandomState(0)
    if config == "inference":
        t, s = common.frames(model, 8), common.img_size(model)
        net, head = common.video_model("timesformer", "divided_space_time",
                                       model, t, device)
        videos = torch.from_numpy(rng.rand(4, batch_size, t, 3, s, s).astype(
            np.float32)).to(device, common.working_dtype(device))

        @torch.inference_mode()
        def infer():
            return [head(net(v)) for v in videos]

        return infer
    if config == "maskfeat":
        cfg, lr = common.maskfeat_configs(model, batch_size), 8e-4
    else:
        cfg, lr = common.finetune_configs(model, batch_size), 5e-3
    with common.tiny_models(model):
        tr = VideoTransformerTrainer(cfg, device)
    if config == "maskfeat":
        batch = common.maskfeat_batch(rng, cfg, batch_size, device)
    else:
        batch = common.finetune_batch(rng, cfg, model, batch_size, device)
    return lambda: tr.train_step(batch, lr, WD)


def run_traced_steps(config, model, batch_size, steps, trace_dir, device):
    """2 steps, then ``steps`` under ``profiling.trace``: (wall ms per
    step, CUDA-event ms per step or None on the CPU, the trace's device
    spans, its top-level CPU ops)."""
    step = build_step(config, model, batch_size, device)
    for _ in range(2):
        step()
    common.sync(device)
    cuda = device.type == "cuda"
    if cuda:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
    with profiling.trace(trace_dir) as prof:
        t0 = time.perf_counter()
        if cuda:
            start.record()
        for _ in range(steps):
            step()
        if cuda:
            end.record()
        common.sync(device)
        wall_ms = (time.perf_counter() - t0) / steps * 1e3
    event_ms = start.elapsed_time(end) / steps if cuda else None
    if config == "inference":
        clips = 4 * batch_size
        print(f"wall per pass (4 batches of {batch_size}): {wall_ms:.1f} ms"
              f" = {clips / wall_ms * 1e3:.1f} clips/s")
    else:
        print(f"wall per step: {wall_ms:.1f} ms")
    if config == "maskfeat":
        algos = "deterministic" if torch.backends.cudnn.deterministic \
            else "default"
        print(f"cuDNN algorithms: {algos}")
    return wall_ms, event_ms, profiling.profile_spans(prof, device), \
        profiling.profile_spans(prof, "cpu")


def run(args):
    """Trace (unless ``--analyze_only``) and analyze; returns the JSON
    line's dict, with the analysis under "analysis"."""
    device = resolve_device(args.device)
    wall_ms = event_ms = None
    if args.analyze_only:
        path = os.path.join(args.trace_dir, "trace.json")
        spans = profiling.chrome_trace_spans(path, device)
        host_spans = profiling.chrome_trace_spans(path, "cpu")
    else:
        wall_ms, event_ms, spans, host_spans = run_traced_steps(
            args.config, args.model, args.batch, args.steps, args.trace_dir,
            device)
    analysis = profiling.analyze(spans, args.steps)
    host = None
    if device.type == "cuda":  # where the host's time goes (on the CPU,
        # the analysis above is the host's)
        print("host: top-level CPU ops (the launches inside them)")
        host = profiling.analyze(host_spans, args.steps, top=15)
    got = (lambda key: None) if analysis is None else analysis.get
    line = {"config": f"trace_step_{args.config}_b{args.batch}",
            "device": common.device_name(device),
            "wall_ms_per_step": wall_ms, "event_ms_per_step": event_ms,
            "device_ms_per_step": got("device_ms"),
            "busy_ms_per_step": got("busy_ms"),
            "idle_share": got("idle_share"),
            "host_share": None if None in (wall_ms, got("busy_ms"))
            else 1 - got("busy_ms") / wall_ms,
            "categories_ms": got("categories"),
            "host_busy_ms_per_step": None if host is None
            else host["busy_ms"]}
    if args.config == "maskfeat":
        line["cudnn_deterministic"] = torch.backends.cudnn.deterministic
    common.emit(line)
    return {**line, "analysis": analysis}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trace_dir", default=os.path.join("build", "vt_trace"))
    ap.add_argument("--analyze_only", action="store_true")
    ap.add_argument("--config", default="finetune",
                    choices=("finetune", "maskfeat", "inference"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--model", choices=("b16", "tiny"), default="b16")
    return ap.parse_args(argv)


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
