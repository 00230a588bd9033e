"""The port's serving path on the CPU: ``TorchPredictor`` over an artifact
written by the JAX package's ``export_predictor`` against the JAX
``make_predict_fn``, the port's ``InferenceServer`` answering concurrent
``submit`` calls, and the port's eval transform and clip loading against the
JAX package's. Tolerance for fp32 logits: 1e-4 · max|ref| (summation order
only); for transformed clips: 1e-5 absolute (resize as F.interpolate against
two weight matmuls, on values of order 1)."""

import http.client
import json
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videotransformer_tpu import config as vt_config
from videotransformer_tpu.data import transforms as jT
from videotransformer_tpu.data.video_reader import VideoReader as JVideoReader
from videotransformer_tpu.models.timesformer import TimeSformer as JTimeSformer
from videotransformer_tpu.ops.blocks import ClassificationHead as JHead
from videotransformer_tpu.serving.export import (
    export_predictor, make_predict_fn as jax_make_predict_fn,
    make_raw_predict_fn as jax_make_raw_predict_fn, unflatten_params)
from videotransformer_tpu.tools import demo_inference as jdemo
from videotransformer_tpu_torch.data.transforms import eval_transform_clip
from videotransformer_tpu_torch.data.video_reader import VideoReader
from videotransformer_tpu_torch.serving.predictor import (
    TorchPredictor, load_predictor)
from videotransformer_tpu_torch.serving.server import InferenceServer
from videotransformer_tpu_torch.tools.demo_inference import load_clip
from test_torch_native_decoder import decode_backend  # noqa: F401

NUM_CLASS, FRAMES, IMG = 10, 4, 128
MEAN, STD = (0.45,) * 3, (0.225,) * 3


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """A clips-mode JAX serving artifact of a tiny TimeSformer whose
    parameters are all perturbed from a numpy seed."""
    model = JTimeSformer(num_frames=FRAMES, img_size=IMG, patch_size=16,
                         embed_dims=64, num_heads=4, num_transformer_layers=2,
                         drop_path_rate=0.0)
    head = JHead(NUM_CLASS, 64)
    vt_config.set_attention_backend("xla")
    try:
        params = jax.jit(model.init)(
            jax.random.PRNGKey(0), jnp.zeros((1, FRAMES, 3, IMG, IMG)))["params"]
        hparams = head.init(jax.random.PRNGKey(1), jnp.zeros((1, 64)))["params"]
        rng = np.random.RandomState(2)
        params, hparams = jax.tree.map(
            lambda a: jnp.asarray(
                np.asarray(a) + rng.randn(*a.shape).astype(np.float32) * 0.05),
            (params, hparams))
        path = str(tmp_path_factory.mktemp("artifact"))
        export_predictor(path, model, head, params, hparams,
                         num_frames=FRAMES, num_class=NUM_CLASS, img_size=IMG,
                         buckets=(1, 2), platforms=("cpu",))
        clips = np.random.RandomState(3).rand(
            3, 3, FRAMES, 3, IMG, IMG).astype(np.float32)
        want = np.asarray(jax_make_predict_fn(model, head, NUM_CLASS, 3)(
            params, hparams, jnp.asarray(clips)))
    finally:
        vt_config.set_attention_backend("auto")
    return path, clips, want


def test_predictor_matches_jax_make_predict_fn(artifact):
    path, clips, want = artifact
    pred = load_predictor(path, "cpu", num_heads=4, dtype=torch.float32)
    assert pred.buckets == [1, 2] and pred.max_batch == 2
    assert pred.n_crops == 3 and pred.manifest["num_class"] == NUM_CLASS
    pred.warmup()
    got = pred(clips)  # B=3 runs as a chunk of 2 and one of 1
    assert got.shape == (3, NUM_CLASS) and got.dtype == np.float32
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1e-4, err
    np.testing.assert_allclose(pred(clips[1:2]), got[1:2], rtol=1e-5,
                               atol=1e-6)


@pytest.fixture(scope="module")
def raw_artifact(artifact, tmp_path_factory):
    """A raw-mode artifact of the same model (requests (T, 48, 64, 3) uint8)
    and the JAX ``make_raw_predict_fn``'s logits of 3 requests for 3 crops
    and for 1 (CenterCrop)."""
    model = JTimeSformer(num_frames=FRAMES, img_size=IMG, patch_size=16,
                         embed_dims=64, num_heads=4, num_transformer_layers=2,
                         drop_path_rate=0.0)
    head = JHead(NUM_CLASS, 64)
    path, _, _ = artifact
    with np.load(f"{path}/params.npz") as flat:
        flat = {k: flat[k] for k in flat.files}
    params = unflatten_params({k[6:]: v for k, v in flat.items()
                               if k.startswith("model/")})
    hparams = unflatten_params({k[5:]: v for k, v in flat.items()
                                if k.startswith("head/")})
    raw = np.random.RandomState(8).randint(
        0, 256, (3, FRAMES, 48, 64, 3)).astype(np.uint8)
    vt_config.set_attention_backend("xla")
    try:
        out = str(tmp_path_factory.mktemp("raw_artifact"))
        export_predictor(out, model, head, params, hparams,
                         num_frames=FRAMES, num_class=NUM_CLASS, img_size=IMG,
                         buckets=(1, 2), platforms=("cpu",),
                         input_mode="raw", raw_hw=(48, 64))
        want = {n: np.asarray(jax_make_raw_predict_fn(
            model, head, NUM_CLASS, n, IMG)(params, hparams,
                                            jnp.asarray(raw)))
                for n in (1, 3)}
    finally:
        vt_config.set_attention_backend("auto")
    return out, raw, want


@pytest.mark.parametrize("n_crops", [3, 1])
def test_raw_predictor_matches_jax_make_raw_predict_fn(raw_artifact,
                                                       n_crops):
    """uint8 requests pad to the bucket and go to the device as uint8; the
    eval recipe (ThreeCrop, or CenterCrop for 1 crop) runs there."""
    path, raw, want = raw_artifact
    pred = load_predictor(path, "cpu", num_heads=4, dtype=torch.float32)
    if n_crops == 1:
        pred = TorchPredictor(pred.model, pred.head,
                              {**pred.manifest, "n_crops": 1}, "cpu",
                              dtype=torch.float32)
    assert pred.input_mode == "raw" and pred.input_dtype == np.uint8
    assert pred.input_shape == (FRAMES, 48, 64, 3)
    seen = []
    real = pred._predict
    pred._predict = lambda x: seen.append(x.dtype) or real(x)
    got = pred(raw)  # B=3 runs as a chunk of 2 and one of 1
    assert seen == [torch.uint8, torch.uint8]
    assert got.shape == (3, NUM_CLASS)
    err = np.abs(got - want[n_crops]).max() / np.abs(want[n_crops]).max()
    assert err <= 1e-4, err
    pred.warmup()


def _write_mp4(path, frames=40, hw=(160, 200), seed=6):
    cv2 = pytest.importorskip("cv2")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25,
                             hw[::-1])
    assert writer.isOpened()
    rng = np.random.RandomState(seed)
    for _ in range(frames):
        writer.write(rng.randint(0, 256, hw + (3,), dtype=np.uint8))
    writer.release()
    with open(path, "rb") as f:
        return f.read()


def test_server_raw_preprocess_bytes_matches_jax(raw_artifact, tmp_path,
                                                 decode_backend):
    """Raw mode: the host only decodes (short edge to 48 at decode, a
    temporal window from the transforms' generator, cropped or padded to
    48 x 64); both servers read through their default reader, set to
    ``decode_backend``. Then the port's server answers the bytes as its
    predictor answers the clip."""
    from types import SimpleNamespace

    from videotransformer_tpu.serving.server import (
        InferenceServer as JInferenceServer)
    from videotransformer_tpu_torch.data import transforms as T

    data = _write_mp4(str(tmp_path / "clip.mp4"))
    path, _, _ = raw_artifact
    pred = load_predictor(path, "cpu", num_heads=4, dtype=torch.float32)
    stub = SimpleNamespace(input_mode="raw", input_shape=pred.input_shape,
                           input_dtype=np.uint8)
    jserver = JInferenceServer(stub, num_frames=FRAMES, frame_interval=8)
    server = InferenceServer(pred, num_frames=FRAMES, frame_interval=8,
                             img_size=IMG, max_batch=2)
    try:
        for seed in (0, 1):
            jT.seed_transforms(seed)
            T.seed_transforms(seed)
            want = jserver.preprocess_bytes(data)
            got = server.preprocess_bytes(data)
            assert got.shape == (FRAMES, 48, 64, 3) and got.dtype == np.uint8
            np.testing.assert_array_equal(got, want)
        T.seed_transforms(0)
        answer = server.predict_bytes(data)
        T.seed_transforms(0)
        logits = pred(server.preprocess_bytes(data)[None])[0]
    finally:
        server.stop()
        jserver.stop()
    assert answer["class_id"] == int(np.argmax(logits))


def test_server_batches_concurrent_submits(artifact):
    path, _, _ = artifact
    pred = load_predictor(path, "cpu", num_heads=4, dtype=torch.float32)
    rng = np.random.RandomState(4)
    clips = [eval_transform_clip(
        rng.randint(0, 256, (FRAMES, 144, 180, 3), dtype=np.uint8),
        MEAN, STD, IMG) for _ in range(6)]
    direct = [pred(c[None])[0] for c in clips]
    server = InferenceServer(pred, num_frames=FRAMES, img_size=IMG,
                             max_batch=pred.max_batch, batch_window_ms=300.0)
    results = [None] * len(clips)
    start = threading.Barrier(len(clips))

    def client(i):
        start.wait()
        results[i] = server.submit(clips[i]).result(timeout=60)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(clips))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=90)
        assert not any(t.is_alive() for t in threads)
        port = server.serve(port=0)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.request("GET", "/healthz")
        assert json.loads(conn.getresponse().read()) == {"ok": True}
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        server.stop()
    for got, want in zip(results, direct):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    hist = {int(k): v for k, v in stats["batch_histogram"].items()}
    assert sum(k * v for k, v in hist.items()) == len(clips)
    assert max(hist) > 1, hist
    assert stats["latency_ms"]["p50"] is not None


def _jax_eval_transform(video, img_size):
    video = video.transpose(0, 3, 1, 2).astype(np.float32)
    transform = jT.Compose([
        jT.Resize(scale_range=(-1, 256)),
        jT.ThreeCrop(size=img_size),
        jT.ToTensor(),
        jT.Normalize(list(MEAN), list(STD)),
    ])
    transform.randomize_parameters()
    return transform(video)


@pytest.mark.parametrize("hw, img_size", [
    ((144, 180), 128),   # landscape, upscaled
    ((300, 240), 224),   # portrait, downscaled
    ((256, 340), 224),   # short edge already 256: no resize
])
def test_eval_transform_matches_jax(hw, img_size):
    video = np.random.RandomState(5).randint(0, 256, (3, *hw, 3),
                                             dtype=np.uint8)
    got = eval_transform_clip(video, MEAN, STD, img_size)
    want = _jax_eval_transform(video, img_size)
    assert got.shape == want.shape == (3, 3, 3, img_size, img_size)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_load_clip_matches_jax(tmp_path, monkeypatch, decode_backend):
    """An mp4 written by OpenCV, read by both packages' readers through
    ``decode_backend``, and through both ``load_clip``s."""
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / "clip.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25,
                             (200, 160))
    assert writer.isOpened()
    rng = np.random.RandomState(6)
    for _ in range(40):
        writer.write(rng.randint(0, 256, (160, 200, 3), dtype=np.uint8))
    writer.release()

    indices = [31, 0, 7, 7, 39]
    want = JVideoReader(path, backend=decode_backend)
    got = VideoReader(path)
    assert want.backend == got.backend == decode_backend
    assert len(got) == len(want) == 40
    np.testing.assert_array_equal(got.get_batch(indices),
                                  want.get_batch(indices))
    got.close()
    want.close()

    monkeypatch.setattr(jdemo, "VideoReader",
                        lambda p: JVideoReader(p, backend=decode_backend))
    jT.seed_transforms(7)
    want_clip = jdemo.load_clip(path, FRAMES, 4, MEAN, STD)
    got_clip = load_clip(path, FRAMES, 4, MEAN, STD,
                         rng=np.random.default_rng(7))
    assert got_clip.shape == want_clip.shape == (3, FRAMES, 3, 224, 224)
    np.testing.assert_allclose(got_clip, want_clip, rtol=0, atol=1e-5)
