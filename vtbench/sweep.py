"""Find the highest rate a serve cell sustains: one process, the cell's
program and server set up once, then an open loop at each rate.

    python3 vtbench/sweep.py --workload <cell> --rates 80,120,160 \\
        [--seconds 20] [--seed 1]

One JSON line a rate: requests, p50/p95/p99 ms, answers a second, and the
mean latency of the last quarter of the requests over the first quarter
(well above 1: the backlog grew through the run). The traffic file's
``rate`` is then set once, by hand, to about four fifths of the highest
rate whose backlog did not grow.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    from vtbench import run as runmod

    runmod.set_environment()
    import numpy as np
    import torch

    from vtbench import registry
    from vtbench.drivers import serve
    from vtbench.spans import Spans

    from videotransformer_tpu_torch.serving.server import InferenceServer

    cell = registry.cell(ROOT, args.workload)
    cfg, s = cell.config, cell.config["serving"]
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    predictor = serve.load_predictor(cell, args.seed, device)
    pool = [serve.pool_clip(cfg, args.seed, i, device).cpu().numpy()
            for i in range(cell.traffic["pool_clips"])]
    predictor.warmup()
    spans = Spans()
    for rate in [float(r) for r in args.rates.split(",")]:
        server = InferenceServer(
            serve.TimedPredictor(predictor, spans),
            num_frames=cfg["num_frames"], img_size=cfg["img_size"],
            n_crops=s["n_crops"], max_batch=s["max_batch"],
            batch_window_ms=s["batch_window_ms"])
        tr = dict(cell.traffic, rate=rate)
        due, clips = serve.schedule(tr, args.seed, args.seconds, rate)
        try:
            t0, reqs, behind = serve.open_loop(server, pool, due, clips,
                                               spans)
            lat, _, failed = serve.settle(reqs, t0 + args.seconds + 120)
            t1 = max(d[0] for _, _, d in reqs if d)
        finally:
            server.stop()
        ms = np.asarray(lat) * 1e3
        q = max(1, len(ms) // 4)
        print(json.dumps({
            "rate": rate, "requests": len(reqs), "failed": failed,
            "p50_ms": float(np.percentile(ms, 50)),
            "p95_ms": float(np.percentile(ms, 95)),
            "p99_ms": float(np.percentile(ms, 99)),
            "answers_per_s": len(lat) / (t1 - t0),
            "last_over_first": float(ms[-q:].mean() / ms[:q].mean()),
            "behind_ms": behind * 1e3,
            "batches": server.stats.snapshot()["batch_histogram"]}),
            flush=True)
    return 0


if __name__ == "__main__":
    if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
            os.path.abspath(__file__)):
        sys.path[0] = ROOT
    sys.exit(main())
