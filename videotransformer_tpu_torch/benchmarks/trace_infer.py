"""Trace inference forwards of the port under torch.profiler and print the
device time by category: the inference twin of ``trace_step.py``.

Twin of ``benchmarks/trace_infer.py``. Configs:

- ``--arch timesformer``: the TimeSformer-B 8x224 bf16 forward with its
  400-class head;
- ``--arch mvit``: MViT-B's supervised features (MaskFeat's trunk, 16x224
  bf16, ``forward_features(x)[:, 0]``).

Each rep runs ``--scans`` batches (JAX's ``lax.scan`` becomes a host loop)
after one rep of warm-up; it prints the wall time and clips/s, then
``utils/profiling.py::analyze`` per batch and a JSON line.

    python -m videotransformer_tpu_torch.benchmarks.trace_infer \\
        [--arch mvit] [--batch 8] [--scans 4] [--reps 3] [--trace_dir DIR] \\
        [--analyze_only] [--device cpu --model tiny]
"""

import argparse
import os
import time

import numpy as np
import torch

from videotransformer_tpu_torch.benchmarks import common
from videotransformer_tpu_torch.utils import profiling
from videotransformer_tpu_torch.utils.helpers import resolve_device


def build(arch, model, batch, scans, device):
    """The callable of one rep: ``scans`` forwards of distinct batches."""
    rng = np.random.RandomState(0)
    s = common.img_size(model)
    if arch == "mvit":
        net = common.mvit_model(model, device)
        forward = lambda v: net.forward_features(v)[:, 0]
        t = common.frames(model, 16)
    else:
        t = common.frames(model, 8)
        net, head = common.video_model("timesformer", "divided_space_time",
                                       model, t, device)
        forward = lambda v: head(net(v))
    videos = torch.from_numpy(rng.rand(scans, batch, t, 3, s, s).astype(
        np.float32)).to(device, common.working_dtype(device))

    @torch.inference_mode()
    def rep():
        return [forward(v) for v in videos]

    return rep


def run(args):
    device = resolve_device(args.device)
    steps = args.reps * args.scans
    line = {"config": f"trace_infer_{args.arch}_b{args.batch}",
            "device": common.device_name(device), "clips_per_sec": None}
    if args.analyze_only:
        spans = profiling.chrome_trace_spans(
            os.path.join(args.trace_dir, "trace.json"), device)
    else:
        rep = build(args.arch, args.model, args.batch, args.scans, device)
        rep()  # build the kernels, warm the allocator
        common.sync(device)
        with profiling.trace(args.trace_dir) as prof:
            t0 = time.perf_counter()
            for _ in range(args.reps):
                rep()
            common.sync(device)
            dt = time.perf_counter() - t0
        n_clips = args.batch * steps
        print(f"wall: {dt * 1e3:.1f} ms for {n_clips} clips "
              f"= {n_clips / dt:.1f} clips/s")
        line["clips_per_sec"] = n_clips / dt
        spans = profiling.profile_spans(prof, device)
    analysis = profiling.analyze(spans, steps, top=24)
    got = (lambda key: None) if analysis is None else analysis.get
    line.update({"device_ms_per_batch": got("device_ms"),
                 "busy_ms_per_batch": got("busy_ms"),
                 "idle_share": got("idle_share"),
                 "categories_ms": got("categories")})
    common.emit(line)
    return {**line, "analysis": analysis}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="timesformer",
                    choices=("timesformer", "mvit"))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--scans", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--trace_dir",
                    default=os.path.join("build", "vt_trace_infer"))
    ap.add_argument("--analyze_only", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--model", choices=("b16", "tiny"), default="b16")
    return ap.parse_args(argv)


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
