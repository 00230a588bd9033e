"""Dynamic-batching HTTP inference server.

Port of ``videotransformer_tpu/serving/server.py`` (host code, close to
verbatim): one device thread owns the card; HTTP handler threads decode and
preprocess clips on the host and enqueue; a collector drains the queue up to
the predictor's largest batch bucket or ``batch_window_ms``, whichever comes
first, so concurrent requests share one batched forward.

The per-clip pipeline is the reference notebook's: decode -> linspace frame
sample -> Resize(-1, 256) -> ThreeCrop(224) -> Normalize -> crop-mean logits
-> classmap lookup. With a raw-mode predictor the host only decodes to the
canonical uint8 clip, and the eval recipe runs on the device.

Endpoints:
    POST /predict   body = raw video bytes (mp4)   -> JSON top-5
    GET  /healthz                                  -> {"ok": true}
    GET  /stats     request/batch/latency counters -> JSON

Run: ``python -m videotransformer_tpu_torch.serving.server --export_dir DIR``
"""

import json
import os
import queue
import tempfile
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


class _Stats:
    def __init__(self):
        self._lock = threading.Lock()
        self.requests = 0
        self.errors = 0
        self.batches = {}
        self._lat_ms = []

    def record(self, batch_size, lat_ms_each):
        with self._lock:
            self.batches[batch_size] = self.batches.get(batch_size, 0) + 1
            self._lat_ms.extend(lat_ms_each)
            self._lat_ms = self._lat_ms[-4096:]

    def count_request(self, error=False):
        with self._lock:
            self.requests += 1
            self.errors += int(error)

    def snapshot(self):
        with self._lock:
            lat = sorted(self._lat_ms)
            pct = (lambda p: round(lat[min(len(lat) - 1,
                                           int(p * len(lat)))], 1)) \
                if lat else (lambda p: None)
            return {
                "requests": self.requests,
                "errors": self.errors,
                "batch_histogram": dict(sorted(self.batches.items())),
                "latency_ms": {"p50": pct(0.5), "p90": pct(0.9),
                               "p99": pct(0.99)},
            }


class InferenceServer:
    """Batches concurrent predict calls onto one device thread.

    ``predictor`` is any callable of a batch of requests -> (B, num_class)
    logits that accepts every batch size up to ``max_batch``
    (TorchPredictor pads to its buckets internally): (B, n_crops, T, C, H,
    W) float32, or (B, T, raw_h, raw_w, 3) uint8 where its ``input_mode``
    is "raw"."""

    def __init__(self, predictor, *, num_frames=8, frame_interval=32,
                 img_size=224, n_crops=3, max_batch=8, batch_window_ms=5.0,
                 classmap=None, mean=(0.45,) * 3, std=(0.225,) * 3):
        self.predictor = predictor
        self.num_frames = num_frames
        self.frame_interval = frame_interval
        self.img_size = img_size
        self.n_crops = n_crops
        self.max_batch = max_batch
        self.batch_window_ms = batch_window_ms
        self.mean, self.std = mean, std
        self.idx_to_class = (
            {int(v): k for k, v in classmap.items()} if classmap else {})
        self.stats = _Stats()
        self._queue = queue.Queue()
        self._stop = threading.Event()
        self._collector = threading.Thread(target=self._device_loop,
                                           daemon=True)
        self._collector.start()
        self._httpd = None

    # ---- device side -----------------------------------------------------

    def _device_loop(self):
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            items = [first]
            deadline = time.perf_counter() + self.batch_window_ms / 1000.0
            while len(items) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    items.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            clips = np.stack([c for c, _, _ in items])
            try:
                logits = np.asarray(self.predictor(clips))
                now = time.perf_counter()
                self.stats.record(
                    len(items), [(now - t_in) * 1000 for _, _, t_in in items])
                for (_, fut, _), row in zip(items, logits):
                    fut.set_result(row)
            except Exception as e:  # propagate to every waiter
                for _, fut, _ in items:
                    if not fut.done():
                        fut.set_exception(e)

    def submit(self, clip) -> Future:
        """clip -> Future of (num_class,) logits. The clip's layout follows
        the predictor's input mode: (n_crops, T, C, S, S) float32, or the
        canonical (T, H, W, 3) uint8 clip in raw mode."""
        dtype = getattr(self.predictor, "input_dtype", np.float32)
        fut = Future()
        self._queue.put((np.asarray(clip, dtype), fut, time.perf_counter()))
        return fut

    # ---- host side -------------------------------------------------------

    def preprocess_bytes(self, data: bytes):
        """Decode video bytes into the predictor's input layout: clips mode,
        decode + the notebook eval transform on the host -> (n_crops, T, 3,
        S, S) float32; raw mode, the canonical uint8 decode only -> (T,
        raw_h, raw_w, 3) (server.py:137-158)."""
        from videotransformer_tpu_torch.tools.demo_inference import load_clip

        with tempfile.NamedTemporaryFile(suffix=".mp4", delete=False) as f:
            f.write(data)
            tmp = f.name
        try:
            if getattr(self.predictor, "input_mode", "clips") == "raw":
                return self._load_raw_clip(tmp)
            clip = load_clip(tmp, self.num_frames, self.frame_interval,
                             self.mean, self.std)
        finally:
            os.unlink(tmp)
        return np.asarray(clip).reshape(
            self.n_crops, self.num_frames, 3, self.img_size, self.img_size)

    def _load_raw_clip(self, path):
        """The dataset's raw-clip decode (server.py:160-176): the short edge
        resized at decode, a temporal window from ``transforms``' generator,
        frames spread over it from frame 0, cropped or padded to the
        predictor's (raw_h, raw_w)."""
        from videotransformer_tpu_torch.data import transforms as T
        from videotransformer_tpu_torch.data.dataset import (
            canonicalize_raw_clip)
        from videotransformer_tpu_torch.data.video_reader import VideoReader

        raw_h, raw_w = self.predictor.input_shape[1:3]
        vr = VideoReader(path, short_edge=raw_h)
        try:
            start, end = T.TemporalRandomCrop(
                self.num_frames * self.frame_interval)(len(vr))
            indices = np.linspace(0, end - start - 1, self.num_frames,
                                  dtype=int)
            video = vr.get_batch(indices)  # (T, H, W, C) uint8
        finally:
            vr.close()
        return canonicalize_raw_clip(video, (raw_h, raw_w))

    def predict_bytes(self, data: bytes, timeout=120.0):
        clip = self.preprocess_bytes(data)
        logits = self.submit(clip).result(timeout=timeout)
        top = np.argsort(logits)[::-1][:5]
        return {
            "class_id": int(top[0]),
            "class": self.idx_to_class.get(int(top[0]), str(int(top[0]))),
            "top5": [{"id": int(i),
                      "class": self.idx_to_class.get(int(i), str(int(i))),
                      "logit": float(logits[i])} for i in top],
        }

    # ---- HTTP ------------------------------------------------------------

    def serve(self, port=0, host="127.0.0.1"):
        """Start the HTTP front end; returns the bound port."""
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {"ok": True})
                elif self.path == "/stats":
                    self._send(200, outer.stats.snapshot())
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/predict":
                    self._send(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    result = outer.predict_bytes(self.rfile.read(n))
                except Exception as e:  # report the failure to the client
                    outer.stats.count_request(error=True)
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                outer.stats.count_request()
                self._send(200, result)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()
        return self._httpd.server_address[1]

    def stop(self):
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self._collector.join(timeout=5)


def main():
    import argparse

    from videotransformer_tpu_torch.serving.predictor import load_predictor

    p = argparse.ArgumentParser()
    p.add_argument("--export_dir", required=True,
                   help="artifact dir written by the port's "
                        "serving/export.py (served from its predict_b{B}.pt2 "
                        "programs) or by the JAX package's export_predictor "
                        "(params.npz + manifest.json: the model rebuilt from "
                        "the parameter names); any TimeSformer or ViViT type")
    p.add_argument("--device", default="cuda")
    p.add_argument("--num_heads", type=int, default=None,
                   help="head count of a rebuilt model (embed_dims // 64 by "
                        "default); a program carries its own")
    p.add_argument("--port", type=int, default=8471)
    p.add_argument("--classmap", default=None,
                   help="JSON {class name: id}, e.g. "
                        "videotransformer_tpu_torch/data/assets/"
                        "k400_classmap.json; without it answers name "
                        "classes by id")
    p.add_argument("--frame_interval", type=int, default=32)
    p.add_argument("--batch_window_ms", type=float, default=5.0)
    args = p.parse_args()

    predictor = load_predictor(args.export_dir, args.device,
                               num_heads=args.num_heads)
    predictor.warmup()
    classmap = None
    if args.classmap:
        with open(args.classmap) as f:
            classmap = json.load(f)
    server = InferenceServer(
        predictor, num_frames=predictor.manifest["num_frames"],
        frame_interval=args.frame_interval,
        img_size=predictor.manifest["img_size"],
        n_crops=predictor.n_crops, max_batch=predictor.max_batch,
        batch_window_ms=args.batch_window_ms, classmap=classmap)
    port = server.serve(port=args.port)
    print(f"serving on :{port} (buckets {predictor.buckets})", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
