"""The serve driver: an open loop of requests into the port's
``InferenceServer``, which serves the ``torch.export`` program that
``serving/export.py`` writes.

Traffic parameters (``vtbench/traffic/<mix>.json``):

- ``rate``: requests a second, fixed; ``pool_clips``: distinct raw uint8
  clips made from the seed, each request one of them;
- arrivals are Poisson: the gaps are the quantiles of the exponential
  distribution at the rate, in an order drawn from the seed, so every seed
  sends the same number of requests over the same span;
- ``sample``: served requests the reference checks, drawn from the seed;
- ``drain_s``: how long past the window's close a request may take;
- ``trace_seconds``: the open loop's length in the traced window;
- ``metric``, ``percentile``: the end-to-end tail reported.

The server runs at the configuration's ``serving`` settings (buckets,
``max_batch``, ``batch_window_ms``, crops). The program is exported once
per checkout into ``vtbench/.cache/serve/`` (a directory named by the
configuration and a hash of the torch version and the port's sources it
traces), then loaded in each run and given the benchmark's weights; the
server's predictor is a thin callable that times each call and forwards
the predictor's attributes. Each request is timed from when it was due
to when its logits are set.
"""

import gc
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

from vtbench import compare, devices, harness, seeds, tracing
from vtbench.drivers import prebuild_kernels
from vtbench.reference import augment, precision
from vtbench.spans import Spans

KERNELS = ("fused_mhsa", "fused_ffn")
TRACED_SOURCES = ("models", "ops", "kernels", "serving",
                  "data/device_augment.py", "data/interpolation.py")


class TimedPredictor:
    """The predictor, each call timed into ``spans`` ("vtbench.predict")
    and its batch size counted; every other attribute is the
    predictor's."""

    def __init__(self, predictor, spans):
        self._predictor = predictor
        self.spans = spans
        self.calls = []  # (t0, t1, batch) of every call

    def __call__(self, clips):
        t0 = time.perf_counter()
        with self.spans.span("vtbench.predict"):
            out = self._predictor(clips)
        self.calls.append((t0, time.perf_counter(), len(clips)))
        return out

    def __getattr__(self, name):
        return getattr(self._predictor, name)


# ------------------------------------------------------------ the program

def _source_hash(cfg):
    import videotransformer_tpu_torch as port

    base = os.path.dirname(os.path.abspath(port.__file__))
    h = hashlib.sha256(torch.__version__.encode())
    h.update(json.dumps(cfg, sort_keys=True).encode())
    for rel in TRACED_SOURCES:
        path = os.path.join(base, rel)
        files = [path] if os.path.isfile(path) else sorted(
            os.path.join(d, f) for d, _, fs in os.walk(path) for f in fs
            if f.endswith((".py", ".cu", ".cuh")))
        for f in files:
            h.update(os.path.relpath(f, base).encode())
            with open(f, "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()[:16]


def manifest(cfg):
    s = cfg["serving"]
    return {"num_frames": cfg["num_frames"], "num_class": cfg["num_class"],
            "img_size": cfg["img_size"], "n_crops": s["n_crops"],
            "buckets": s["buckets"], "input_mode": "raw",
            "input_shape": [cfg["num_frames"], *cfg["raw_hw"], 3],
            "input_dtype": "uint8"}


def program_files(cell):
    """The cell's exported programs, one a bucket, of the model and head
    its adapter builds, exported into the checkout's cache on the first
    run there."""
    from videotransformer_tpu_torch.serving.export import export_program

    cfg = cell.config
    cache = os.path.join(cell.root, "vtbench", ".cache", "serve",
                         f"{cell.config_name}-{_source_hash(cfg)}")
    files = {b: os.path.join(cache, f"predict_b{b}.pt2")
             for b in cfg["serving"]["buckets"]}
    if all(os.path.exists(f) for f in files.values()):
        return files
    os.makedirs(cache, exist_ok=True)
    model, head = cell.model.serving_model(cfg)
    m = manifest(cfg)
    for b, path in files.items():
        program = export_program(
            model, head, [b, *m["input_shape"]], torch.uint8,
            num_class=cfg["num_class"], n_crops=m["n_crops"],
            input_mode="raw", img_size=cfg["img_size"],
            dtype=getattr(torch, cfg["serving"]["dtype"]))
        tmp = path.replace(".pt2", ".partial.pt2")
        torch.export.save(program, tmp)
        os.replace(tmp, path)
    return files


def load_predictor(cell, seed, device):
    """``TorchPredictor.from_programs`` over the cached programs, with the
    benchmark's weights as its parameter inputs."""
    from videotransformer_tpu_torch.serving.predictor import (
        TorchPredictor, load_program, program_module, program_params)

    cfg = cell.config
    loaded = {b: load_program(f, device)
              for b, f in program_files(cell).items()}
    (dtype,) = {dt for _, dt in loaded.values()}
    weights = seeds.make_weights(
        seed, cell.model.reference.param_specs(cfg), device)
    model_sd = {n[len("model."):]: w for n, w in weights.items()
                if n.startswith("model.")}
    head_sd = {n[len("cls_head."):]: w for n, w in weights.items()
               if n.startswith("cls_head.")}
    params, head_params = program_params(model_sd, head_sd, dtype, device)
    del weights
    return TorchPredictor.from_programs(
        {b: program_module(p) for b, (p, _) in loaded.items()}, params,
        head_params, manifest(cfg), device, dtype)


# ------------------------------------------------------------ the traffic

def pool_clip(cfg, seed, i, device):
    """Raw clip ``i`` of the request pool, (T, H, W, 3) uint8 on
    ``device``."""
    g = seeds.generator(device, seed, "request", i)
    return torch.randint(0, 256, (cfg["num_frames"], *cfg["raw_hw"], 3),
                         generator=g, device=device, dtype=torch.uint8)


def schedule(tr, seed, seconds, tag):
    """(due offsets in seconds, pool index) of every request of an open
    loop ``seconds`` long."""
    n = max(1, int(round(tr["rate"] * seconds)))
    gen = seeds.rng(seed, "arrivals", tag)
    q = (np.arange(n) + 0.5) / n
    gaps = gen.permutation(-np.log1p(-q) / tr["rate"])
    due = np.cumsum(gaps) - gaps[0]
    clips = gen.integers(0, tr["pool_clips"], size=n)
    return due, clips


def open_loop(server, pool, due, clips, spans):
    """Submit request k at ``due[k]`` after the start; returns (start,
    [(due time, future, done-time holder)], the latest the generator
    ran behind its schedule)."""
    requests = []
    behind = 0.0
    t0 = time.perf_counter()
    for d, c in zip(due, clips):
        wait = t0 + d - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        when = t0 + d
        behind = max(behind, time.perf_counter() - when)
        done = []
        with spans.span("vtbench.submit"):
            fut = server.submit(pool[c])
        fut.add_done_callback(lambda f, done=done: done.append(
            time.perf_counter()))
        requests.append((when, fut, done))
    return t0, requests, behind


def settle(requests, deadline):
    """Wait for every request until ``deadline``; returns (latencies in
    seconds of the answered ones, their indices, the count never answered
    or failed)."""
    lat, idx, failed = [], [], 0
    for k, (when, fut, done) in enumerate(requests):
        try:
            fut.result(timeout=max(0.0, deadline - time.perf_counter()))
        except Exception:  # never answered, or the server raised
            failed += 1
            continue
        while not done:  # the callback runs right after the result is set
            time.sleep(1e-4)
        lat.append(done[0] - when)
        idx.append(k)
    return lat, idx, failed


# ------------------------------------------------------------ the run

def run(cell, args, started):
    from videotransformer_tpu_torch.serving.server import InferenceServer

    cfg, tr = cell.config, cell.traffic
    device = devices.card(0)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        prebuild_kernels(KERNELS)
    spans = Spans(enabled=bool(args.trace))
    predictor = load_predictor(cell, args.seed, device)
    timed = TimedPredictor(predictor, spans)
    pool = [pool_clip(cfg, args.seed, i, device).cpu().numpy()
            for i in range(tr["pool_clips"])]
    s = cfg["serving"]
    predictor.warmup()
    for k in range(3):  # full buckets of real clips
        predictor(np.stack([pool[(k * s["max_batch"] + j) % len(pool)]
                            for j in range(s["max_batch"])]))
    server = InferenceServer(timed, num_frames=cfg["num_frames"],
                             img_size=cfg["img_size"], n_crops=s["n_crops"],
                             max_batch=s["max_batch"],
                             batch_window_ms=s["batch_window_ms"])
    due, clips = schedule(tr, args.seed, args.seconds, "window")
    devices.quiesce(device)
    setup_s = time.perf_counter() - started
    try:
        t0, requests, behind = open_loop(server, pool, due, clips, spans)
        lat, answered, failed = settle(requests, t0 + args.seconds
                                       + tr["drain_s"])
        stats = server.stats.snapshot()
        if lat:
            tail = np.percentile(np.asarray(lat) * 1e3, tr["percentile"])
            print(f"vtbench: {tr['metric']} {tail:.3f} in the window",
                  file=sys.stderr, flush=True)
        trace = work = None
        if args.trace:
            tdue, tclips = schedule(tr, args.seed, tr["trace_seconds"],
                                    "trace")
            devices.quiesce(device)
            first = len(timed.calls)
            timed.spans = Spans(enabled=True, annotate=True)
            with tracing.window(device) as held:
                tt0, treqs, _ = open_loop(server, pool, tdue, tclips,
                                          timed.spans)
                settle(treqs, tt0 + tr["trace_seconds"] + tr["drain_s"])
            trace = held["trace"]
            calls = timed.calls[first:]
            work = {"buckets": [predictor._bucket(n) for _, _, n in calls],
                    "requests_done": sum(1 for _, _, d in treqs if d)}
    finally:
        server.stop()
    peak = devices.peak_bytes(device)
    served = {k: requests[k][1].result() for k in answered}
    del predictor, timed, server
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    run = harness.Run(cell=cell, traced=bool(args.trace), setup_s=setup_s,
                      chips=1, attempted=len(requests), failed=failed,
                      peak_bytes=peak, spans=spans)
    if lat:
        run.end_to_end[tr["metric"]] = float(
            np.percentile(np.asarray(lat) * 1e3, tr["percentile"]))
    run.counters = {"batch_histogram": stats["batch_histogram"],
                    "behind_s": behind}
    if trace is not None:
        run.trace, run.work = trace, work
        run.busy_s, run.window_s = trace.busy_s(), trace.window_s
        run.breakdown = tracing.breakdown(trace)
    print(f"vtbench: {len(requests)} requests, {failed} failed, the "
          f"generator at most {behind * 1e3:.3f} ms behind",
          file=sys.stderr, flush=True)
    numbers = {"logits": (reference_gap(cell, args.seed, device, served,
                                        clips, precision.Exact()), None)}
    run.checks, ok = compare.judge(numbers,
                                   compare.limits(cell.root, cell.name))
    run.correct = ok and failed == 0
    return run


def sample(seed, served, n):
    keys = sorted(served)
    pick = seeds.rng(seed, "sample").choice(len(keys), size=min(n, len(keys)),
                                            replace=False)
    return [keys[i] for i in sorted(pick)]


def reference_logits(cell, seed, device, pool_indices, ops, weights=None):
    """The reference's crop-mean logits of the pool clips ``pool_indices``
    (n, classes), float32."""
    cfg, ref = cell.config, cell.model.reference
    weights = weights or seeds.make_weights(seed, ref.param_specs(cfg),
                                            device)
    out = []
    with torch.no_grad(), precision.no_tf32():
        for i in pool_indices:
            raw = pool_clip(cfg, seed, int(i), device)[None]
            crops = augment.three_crop(raw, cfg["img_size"],
                                       cfg["augment"]["mean"],
                                       cfg["augment"]["std"])
            lg = ref.logits(weights, crops, cfg, ops)
            out.append(lg.reshape(1, -1, lg.shape[-1]).mean(1))
    return torch.cat(out)


def reference_gap(cell, seed, device, served, clips, ops):
    """``compare.logit_gap`` over the sampled served requests."""
    keys = sample(seed, served, cell.traffic["sample"])
    ref = reference_logits(cell, seed, device, [clips[k] for k in keys], ops)
    got = torch.as_tensor(np.stack([served[k] for k in keys]), device=device)
    return compare.logit_gap(got, ref)
