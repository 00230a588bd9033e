"""The readings the limits of ``vtbench/limits/<cell>.json`` are set from,
on the card at the cell's own sizes, in one process:

- the program's numbers on each of ``--seeds`` (the lower reading is the
  largest over a dozen or more);
- the control's on each of ``--control_seeds``: the reference computed
  in float8 (``reference/precision.py``) in the program's place;
- with ``--faults``, each fault the cell can have on each control seed:
  ``half`` (half of the batch left out, the mean over the rest) and
  ``alter`` (one served answer altered where it is produced), planted in
  the program; in a cell over several cards, ``half`` and
  ``no_exchange`` (the gradient exchange left out) planted in the
  reference put in the program's place, on one card. A state left
  unchanged reads 1 on ``change`` by construction and needs no run.

The program's own readings of a cell over several cards are its runs'
(``run.py`` prints each number compared).

    python3 vtbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --control_seeds 4,5,6 [--faults half] [--seconds 3]

One JSON line per reading, then a summary line: each number's largest
program reading and smallest control and fault readings.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _train_readings(cell, seed, device, fault=None):
    import itertools

    from vtbench.drivers import train

    from videotransformer_tpu_torch.data.pipeline import device_prefetch
    from videotransformer_tpu_torch.training.trainer import (
        VideoTransformerTrainer)

    trainer = VideoTransformerTrainer(train.trainer_configs(cell, seed),
                                      device)
    train.load_weights(trainer, cell, seed, device)
    if fault == "half":
        step = trainer.train_step

        def half(batch, lr, wd):
            n = batch["raw_video"].shape[0] // 2
            return step({k: v[:n] for k, v in batch.items()}, lr, wd)
        trainer.train_step = half
    feed = device_prefetch(itertools.cycle(
        train.host_pool(cell, seed, 0, device)), device)
    prog = train.program_record(trainer, feed, cell.traffic)
    del trainer, feed
    return prog


def train_numbers(cell, seed, device, mode):
    """(numbers) of ``mode``: "program", "control" or a fault."""
    import torch

    from vtbench import compare
    from vtbench.drivers import train
    from vtbench.reference import precision

    world = cell.chips
    if mode == "control" or world > 1:
        if mode == "program":
            raise ValueError("the program over several cards: use run.py")
        got = train.reference_record(
            cell, seed, device,
            precision.Fp8() if mode == "control" else precision.Exact(),
            world, fault=None if mode == "control" else mode)
        got["delta"] = {n: d.cpu() for n, d in got["delta"].items()}
    else:
        got = _train_readings(cell, seed, device,
                              None if mode == "program" else mode)
    torch.cuda.empty_cache()
    ref = train.reference_record(cell, seed, device, precision.Exact(),
                                 world)
    return {k: v for k, (v, _) in compare.training_numbers(got, ref).items()}


def serve_numbers(cell, seed, device, mode, seconds):
    """The served sample's logit gap: the program's through a short open
    loop at the cell's rate, the control's, or with one answer altered."""
    from types import SimpleNamespace

    import torch

    from vtbench import compare
    from vtbench.drivers import serve
    from vtbench.reference import precision

    if mode == "control":
        keys = list(range(cell.traffic["sample"]))
        idx = serve.schedule(cell.traffic, seed, seconds, "window")[1][keys]
        ref = serve.reference_logits(cell, seed, device, idx,
                                     precision.Exact())
        ctl = serve.reference_logits(cell, seed, device, idx,
                                     precision.Fp8())
        return {"logits": compare.logit_gap(ctl, ref)}
    args = SimpleNamespace(seed=seed, seconds=seconds, trace=0)
    if mode == "alter":
        real = serve.TimedPredictor.__call__

        def altered(self, clips):
            out = real(self, clips)
            out[0] = out[0][::-1].copy()  # one answer's logits reversed
            return out
        serve.TimedPredictor.__call__ = altered
        try:
            run = serve.run(cell, args, time.perf_counter())
        finally:
            serve.TimedPredictor.__call__ = real
    else:
        run = serve.run(cell, args, time.perf_counter())
    torch.cuda.empty_cache()
    return {r["name"]: r["value"] for r in run.checks}


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control_seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    from vtbench import run as runmod

    runmod.set_environment()
    import torch

    from vtbench import registry

    cell = registry.cell(ROOT, args.workload)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    numbers = (serve_numbers if cell.traffic["driver"] == "serve"
               else lambda c, s, d, m, _: train_numbers(c, s, d, m))
    seeds_of = lambda text: [int(s) for s in text.split(",") if s]
    plan = [("program", s) for s in seeds_of(args.seeds)]
    plan += [("control", s) for s in seeds_of(args.control_seeds)]
    plan += [(f, s) for f in args.faults.split(",") if f
             for s in seeds_of(args.control_seeds)]
    summary = {}
    for mode, seed in plan:
        t0 = time.perf_counter()
        got = numbers(cell, seed, device, mode, args.seconds)
        print(json.dumps({"cell": cell.name, "mode": mode, "seed": seed,
                          "numbers": got,
                          "s": round(time.perf_counter() - t0, 1)}),
              flush=True)
        for k, v in got.items():
            summary.setdefault(mode, {}).setdefault(k, []).append(v)
    print(json.dumps({"cell": cell.name, "summary": {
        m: {k: {"max": max(v), "min": min(v), "n": len(v)}
            for k, v in d.items()} for m, d in summary.items()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
            os.path.abspath(__file__)):
        sys.path[0] = ROOT
    sys.exit(main())
