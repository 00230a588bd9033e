"""Serving-path benchmark of the port: an exported predictor behind the
dynamic-batching InferenceServer, on the card.

Twin of ``benchmarks/serve_bench.py`` (:26-132). It exports TimeSformer-B
8x224 and its 400-class head (random weights from a seed) with the port's
``serving/export.py`` (``--input_mode raw`` by default: uint8 clips, the
eval recipe on the device), loads it with ``load_predictor(path,
device)``, serves it with ``max_batch=8`` and a 5 ms window, and prints
one JSON line per scenario with the JAX keys:

- the warm-up of every bucket;
- single stream: one request in flight, p50 and p90 request ms over 20;
- ``--concurrency`` closed-loop clients for ``--seconds``: clips/s, p50
  and p99 request ms, the batch histogram.

Every request carries the same clip; ``run`` returns the lines and the
answers, for a caller to hold against the predictor's direct answer.
On the tiny geometry the uint8 clips are 40x54.

    python -m videotransformer_tpu_torch.benchmarks.serve_bench \\
        [--concurrency 16] [--seconds 10] [--artifact DIR] \\
        [--input_mode raw|clips] [--device cpu --model tiny]
"""

import argparse
import tempfile
import threading
import time

import numpy as np

from videotransformer_tpu_torch.benchmarks import common
from videotransformer_tpu_torch.serving.export import export_predictor
from videotransformer_tpu_torch.serving.predictor import load_predictor
from videotransformer_tpu_torch.serving.server import InferenceServer
from videotransformer_tpu_torch.utils.helpers import resolve_device

BUCKETS = (1, 2, 4, 8)


def build_artifact(path, model, input_mode="raw"):
    """Export the model's artifact (fp32 weights, from seeds 0 and 1) to
    ``path``."""
    t = common.frames(model, 8)
    net, head = common.video_model("timesformer", "divided_space_time",
                                   model, t, resolve_device("cpu"))
    export_predictor(path, net, head, num_frames=t,
                     num_class=common.NUM_CLASS,
                     img_size=common.img_size(model), n_crops=3,
                     buckets=BUCKETS, input_mode=input_mode,
                     raw_hw=common.RAW_HW[model])


def run(args):
    """(the scenarios' JSON lines, the clip, every answer as a
    (num_class,) array, the predictor)."""
    device = resolve_device(args.device)
    lines = []

    def emit(line):
        common.emit(line)
        lines.append(line)

    with tempfile.TemporaryDirectory(prefix="vt_serve_bench_") as tmp:
        path = args.artifact or tmp
        if not args.artifact:
            build_artifact(path, args.model, args.input_mode)
        predictor = load_predictor(path, device, num_heads=None if
                                   args.model == "b16" else
                                   common.TINY["num_heads"])
    t0 = time.perf_counter()
    predictor.warmup()
    mode = predictor.input_mode
    emit({"config": "serving_warmup", "artifact": args.artifact,
          "input_mode": mode, "device": common.device_name(device),
          "warmup_s": round(time.perf_counter() - t0, 1)})

    t = predictor.manifest["num_frames"]
    srv = InferenceServer(predictor, num_frames=t, n_crops=3, max_batch=8,
                          batch_window_ms=5.0)
    rng = np.random.RandomState(0)
    if mode == "raw":
        clip = (rng.rand(*predictor.input_shape) * 255).astype(np.uint8)
    else:
        clip = rng.rand(*predictor.input_shape).astype(np.float32)
    answers = []
    lock = threading.Lock()

    def request():
        out = srv.submit(clip).result(timeout=120)
        with lock:
            answers.append(out)

    try:
        # single stream: one request in flight (the batching window adds
        # nothing when the queue is empty beyond its first-item bypass)
        request()  # device wake-up
        lats = []
        for _ in range(20):
            t0 = time.perf_counter()
            request()
            lats.append((time.perf_counter() - t0) * 1000)
        lats.sort()
        emit({"config": f"serving_timesformer_b_3crop_{mode}_single_stream",
              "device": common.device_name(device),
              "p50_request_ms": round(lats[len(lats) // 2], 1),
              "p90_request_ms": round(lats[int(len(lats) * 0.9)], 1)})

        # sustained throughput: N closed-loop clients for S seconds
        stop = time.perf_counter() + args.seconds
        done = [0] * args.concurrency
        req_lat = []

        def client(i):
            while time.perf_counter() < stop:
                t0 = time.perf_counter()
                request()
                dt = (time.perf_counter() - t0) * 1000
                with lock:
                    done[i] += 1
                    req_lat.append(dt)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(args.concurrency)]
        t_start = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=args.seconds + 240)
        if any(th.is_alive() for th in threads):
            raise RuntimeError("a serve_bench client did not finish")
        wall = time.perf_counter() - t_start
        req_lat.sort()
        snap = srv.stats.snapshot()
    finally:
        srv.stop()
    emit({"config": f"serving_timesformer_b_3crop_{mode}_concurrency"
                    f"{args.concurrency}",
          "device": common.device_name(device),
          "clips_per_sec": round(sum(done) / wall, 1),
          "p50_request_ms": round(req_lat[len(req_lat) // 2], 1),
          "p99_request_ms": round(req_lat[int(len(req_lat) * 0.99)], 1),
          "batch_histogram": snap["batch_histogram"]})
    return lines, clip, answers, predictor


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--concurrency", type=int, default=16)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--artifact", default=None,
                    help="reuse a prebuilt artifact dir (skips export)")
    ap.add_argument("--input_mode", default="raw", choices=("raw", "clips"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--model", choices=("b16", "tiny"), default="b16")
    return ap.parse_args(argv)


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
