"""The port's host data path against the JAX package's, on the CPU: the
resize weights, the host transforms and RandAugment under the same numpy
seeds, ``canonicalize_raw_clip``, the decode with its short-edge resize,
``Kinetics`` over the bundled demo clips (raw, float and mim), the collates,
the ``Loader`` (order, length, a worker's error, every worker gone, no
progress) and the prefetch on a CPU device.

The decode comparisons run once for each backend (``decode_backend``, from
test_torch_native_decoder.py): both packages through OpenCV, and both
through their default ``auto``, which is the native FFmpeg reader here; the
decoded frames are bit-equal either way. Tolerances: the resize
weights are copies (equal); a resize is two fp32 products, numpy's einsum
against torch.matmul: 1e-3 on 0-255 pixels, 1e-5 after ToTensor +
Normalize; everything else equal. Each ``Loader`` test passes its own
``worker_timeout`` and bounds its own wait.
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX package's modules import it)

from videotransformer_tpu.data import dataset as jdataset
from videotransformer_tpu.data import interpolation as jinterp
from videotransformer_tpu.data import pipeline as jpipeline
from videotransformer_tpu.data import rand_augment as jra
from videotransformer_tpu.data import transforms as jT
from videotransformer_tpu.data import video_reader as jvr
from videotransformer_tpu_torch.data import dataset, interpolation, pipeline
from videotransformer_tpu_torch.data import rand_augment as pra
from videotransformer_tpu_torch.data import transforms as T
from videotransformer_tpu_torch.data.video_reader import (
    DecordInit, VideoReader)
from test_torch_native_decoder import decode_backend  # noqa: F401

DEMO = "videotransformer_tpu/data/assets/demo"
DEMO_LIST = f"{DEMO}/demo_train_list.txt"
DEMO_CLASSMAP = f"{DEMO}/demo_classmap.json"


@pytest.mark.parametrize("method", ["bicubic", "bilinear", "nearest"])
@pytest.mark.parametrize("n_in,n_out", [(40, 24), (24, 40), (342, 224),
                                        (17, 17)])
def test_resize_matrix_is_the_jax_packages(method, n_in, n_out):
    np.testing.assert_array_equal(
        interpolation.resize_matrix(n_in, n_out, method),
        jinterp.resize_matrix(n_in, n_out, method))


@pytest.mark.parametrize("short", [24, 40])
def test_resize_hw_and_short_edge_match_jax(short):
    img = np.random.default_rng(0).uniform(0, 255, (2, 3, 30, 44)).astype(
        np.float32)
    got = interpolation.resize_hw(torch.from_numpy(img), 20, 26)
    np.testing.assert_allclose(got.numpy(), jinterp.resize_hw(img, 20, 26),
                               rtol=0, atol=1e-3)
    got = interpolation.resize_short_edge(torch.from_numpy(img), short)
    want = jinterp.resize_short_edge(img, short)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def _clip(seed=0, t=3, h=48, w=64):
    return np.random.default_rng(seed).integers(
        0, 256, (t, 3, h, w)).astype(np.float32)


TRANSFORMS = {
    "train_supervised": lambda m: m.transforms_train(32),
    "train_hue_and_grayscale": lambda m: m.Compose([
        m.TorchvisionRandomResizedCrop(32, scale=(0.5, 1.0)),
        m.Flip(0.3), m.ColorJitter(0.4, 0.4, 0.4, 0.2),
        m.RandomGrayscale(0.5), m.ToTensor(),
        m.Normalize([0.45] * 3, [0.225] * 3)]),
    "train_auto_augment": lambda m: m.transforms_train(
        32, auto_augment="rand-m9-mstd0.5"),
    "eval": lambda m: m.transforms_eval(32),
    "test_three_crop": lambda m: m.Compose([
        m.Resize((-1, 40)), m.ThreeCrop(32), m.ToTensor(),
        m.Normalize([0.45] * 3, [0.225] * 3)]),
    "crops_and_apply": lambda m: m.Compose([
        m.Resize((36, 44)), m.RandomCrop(34),
        m.RandomApply([m.RandomResizedCrop(32)], p=0.7),
        m.CenterCrop(30)]),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_host_transforms_match_jax_under_one_seed(name):
    for seed in range(4):
        jT.seed_transforms(seed)
        T.seed_transforms(seed)
        want_t, got_t = TRANSFORMS[name](jT), TRANSFORMS[name](T)
        for clip_seed in range(2):  # two clips: two draws each
            clip = _clip(clip_seed)
            want_t.randomize_parameters()
            got_t.randomize_parameters()
            want, got = want_t(clip), got_t(clip)
            assert got.shape == want.shape and got.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-3,
                                       err_msg=f"{seed} {clip_seed}")


def test_mim_transform_pair_and_temporal_crop_match_jax():
    jT.seed_transforms(3)
    T.seed_transforms(3)
    jpre, jpost = jT.transforms_train(32, scale=(0.5, 1.0), color_jitter=None,
                                      objective="mim")
    pre, post = T.transforms_train(32, scale=(0.5, 1.0), color_jitter=None,
                                   objective="mim")
    jpre.randomize_parameters()
    pre.randomize_parameters()
    mid = pre(_clip())
    np.testing.assert_allclose(mid, jpre(_clip()), rtol=0, atol=1e-3)
    np.testing.assert_allclose(post(mid), jpost(mid), rtol=0, atol=1e-5)
    crop, jcrop = T.TemporalRandomCrop(32), jT.TemporalRandomCrop(32)
    assert [crop(n) for n in (10, 40, 400, 33)] == \
        [jcrop(n) for n in (10, 40, 400, 33)]


@pytest.mark.parametrize("name", [
    "Identity", "ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate",
    "Brightness", "Color", "Contrast", "Sharpness", "Posterize", "Solarize",
    "AutoContrast", "Equalize"])
def test_host_rand_augment_ops_match_jax(name):
    pytest.importorskip("cv2")
    clip = _clip(4, h=40, w=52)
    mags = {"Posterize": (6.0, 4.0), "Solarize": (128.0, 200.0)}
    for mag in mags.get(name, (0.2, -0.2, 0.0)):
        want_ra, got_ra = jra.RandAugment(), pra.RandAugment()
        want_ra._chosen = got_ra._chosen = [(name, mag)]
        np.testing.assert_array_equal(got_ra(clip), want_ra(clip))


def test_host_rand_augment_draws_match_jax():
    jT.seed_transforms(5)
    T.seed_transforms(5)
    want_ra, got_ra = jra.RandAugment(), pra.RandAugment()
    for _ in range(20):
        want_ra.randomize_parameters()
        got_ra.randomize_parameters()
        assert got_ra._chosen == want_ra._chosen


@pytest.mark.parametrize("shape,hw", [
    ((2, 256, 341, 3), (256, 342)),   # pad the width
    ((2, 256, 455, 3), (256, 342)),   # crop the width
    ((2, 300, 400, 3), (256, 342)),   # crop both
    ((2, 192, 256, 3), (256, 342)),   # pad both
])
def test_canonicalize_raw_clip_matches_jax(shape, hw):
    video = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    got = dataset.canonicalize_raw_clip(video, hw)
    assert got.shape == (2,) + hw + (3,) and got.dtype == np.uint8
    np.testing.assert_array_equal(got,
                                  jdataset.canonicalize_raw_clip(video, hw))


@pytest.mark.parametrize("start,end,n", [(0, 39, 8), (5, 12, 8), (30, 60, 4)])
def test_temporal_sampling_matches_jax(start, end, n):
    frames = np.arange(40)[:, None] * np.ones((1, 3))
    np.testing.assert_array_equal(
        dataset.temporal_sampling(frames, start, end, n),
        jdataset.temporal_sampling(frames, start, end, n))


@pytest.mark.parametrize("short_edge", [0, 256, 100])
def test_reader_short_edge_and_fps_match_jax(decode_backend, short_edge):
    path = f"{DEMO}/checker_spin_0.mp4"
    want = jvr.VideoReader(path, backend=decode_backend,
                           short_edge=short_edge)
    got = VideoReader(path, backend=decode_backend, short_edge=short_edge)
    assert want.backend == got.backend == decode_backend
    assert len(got) == len(want) and got.fps == want.fps == 25.0
    idx = [0, 39, 5, 5, 20]
    frames = got.get_batch(idx)
    np.testing.assert_array_equal(frames, want.get_batch(idx))
    if short_edge:
        assert frames.shape[1] == short_edge
    got.close()
    want.close()
    reader = DecordInit(num_threads=2)(path)
    assert len(reader) == 40 and repr(DecordInit(2)).endswith("=2)")
    assert reader.backend == decode_backend
    reader.close()


def _configs(objective="supervised", **over):
    cfg = dict(num_class=4, num_samples_per_cls=10000, num_frames=4,
               frame_interval=4, objective=objective, img_size=32,
               classmap_path=DEMO_CLASSMAP)
    cfg.update(over)
    return SimpleNamespace(**cfg)


def _kinetics_pair(cfg, seed, **kw):
    """Both packages' Kinetics over the demo list, their generators
    (transforms, python random, cube masks) seeded alike."""
    import random

    jT.seed_transforms(seed)
    T.seed_transforms(seed)
    random.seed(seed)
    transform = kw.pop("transform", None)
    want = jdataset.Kinetics(cfg, DEMO_LIST, temporal_sample=jT.
                             TemporalRandomCrop(16),
                             transform=transform and transform(jT), **kw)
    got = dataset.Kinetics(cfg, DEMO_LIST, temporal_sample=T.
                           TemporalRandomCrop(16),
                           transform=transform and transform(T), **kw)
    if cfg.objective == "mim":
        want._cube_generator.rng = np.random.default_rng(seed)
        got._cube_generator.rng = np.random.default_rng(seed)
    return want, got


def _assert_samples_equal(got, want, atol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, list):
            assert [list(x) for x in g] == [list(x) for x in w]
        else:
            g, w = np.asarray(g), np.asarray(w)
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_allclose(g, w, rtol=0, atol=atol)


@pytest.mark.parametrize("mode", ["raw", "float", "mim_raw", "mim_host_hog",
                                  "mim_device_hog"])
def test_kinetics_over_the_demo_clips_matches_jax(decode_backend, mode):
    """Raw mode: canonical uint8 (T, 256, 342, 3) clips (the 192 x 256
    demo decodes to 256 x 341 and pads). mim: the bounded mask redraw keeps
    the reference's fault (c) (an all-empty 20th draw is returned as it
    is), as the JAX package does. With ``native`` neither package is
    patched: each ``Kinetics`` decodes through its default path."""
    objective = "mim" if mode.startswith("mim") else "supervised"
    cfg = _configs(objective)
    kw = {"raw_clips": mode in ("raw", "mim_raw")}
    if mode == "float":
        kw["transform"] = lambda m: m.transforms_train(32)
    elif mode.startswith("mim_") and mode != "mim_raw":
        kw["transform"] = lambda m: m.transforms_train(
            32, scale=(0.5, 1.0), color_jitter=None, objective="mim")
        kw["host_hog_targets"] = mode == "mim_host_hog"
    want_ds, got_ds = _kinetics_pair(cfg, 0, **kw)
    assert len(got_ds) == len(want_ds) == 12
    assert got_ds.data == want_ds.data
    for i in (0, 4, 11):
        want, got = want_ds[i], got_ds[i]
        if mode == "raw":
            assert got[0].shape == (4, 256, 342, 3)
        _assert_samples_equal(got, want, 1e-3 if "float" in mode
                              or "hog" in mode else 0)


def test_mask_redraw_returns_the_last_empty_draw_as_the_reference():
    """Fault (c) of the reference, kept: a generator that never draws a
    non-empty mask gives its 20th draw back (dataset.py:172-183)."""
    ds = dataset.Kinetics(_configs("mim"), DEMO_LIST)
    calls = []

    def empty():
        calls.append(1)
        return np.zeros((2, 2, 2), np.int32), [[0, len(calls)]]

    ds._cube_generator = empty
    mask, marker = ds.mask_generator()
    assert not mask.any() and len(calls) == 20 and marker == [[0, 20]]


def test_decode_retry_is_bounded(tmp_path):
    ann = tmp_path / "ann.txt"
    ann.write_text("missing_a.mp4\tbar_slide_h\nmissing_b.mp4\tbar_slide_v\n")
    ds = dataset.Kinetics(_configs(), str(ann),
                          temporal_sample=T.TemporalRandomCrop(16),
                          max_decode_retries=3)
    with pytest.raises(RuntimeError, match="decode failed for 3"):
        ds[0]


def _samples(kind, n=3, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        clip = rng.integers(0, 256, (4, 8, 10, 3), dtype=np.uint8)
        mask = rng.integers(0, 2, (2, 2, 2))
        marker = [[0, 1], [1, 1]][:1 + i % 2]
        if kind == "raw":
            out.append((clip, i))
        elif kind == "supervised":
            out.append((clip.astype(np.float32), i))
        elif kind == "mim_raw":
            out.append((clip, mask, marker))
        else:
            second = rng.random((4, 3, 8, 10)) if kind == "mim_raw_target" \
                else rng.random((4, 2, 2, 108))
            out.append((rng.random((4, 3, 8, 10)), second, mask, marker))
    return out


@pytest.mark.parametrize("kind,name", [
    ("raw", "collate_raw"), ("supervised", "collate_supervised"),
    ("mim_raw", "collate_mim_raw"), ("mim_hog", "collate_mim"),
    ("mim_raw_target", "collate_mim")])
def test_collates_match_jax(kind, name):
    samples = _samples(kind)
    want = getattr(jpipeline, name)(samples)
    got = getattr(pipeline, name)(samples)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


class _Items:
    def __init__(self, n=10, fail_at=None, block=None):
        self.n, self.fail_at, self.block = n, fail_at, block

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise ValueError(f"bad item {i}")
        if self.block is not None and i == 3:
            self.block.wait(timeout=30)
        return np.full((2,), i), i


def _collate(samples):
    return [int(s[1]) for s in samples]


def _consume(loader, limit):
    """Every batch of ``loader``, failing the test after ``limit`` s."""
    start, out = time.monotonic(), []
    for batch in loader:
        out.append(batch)
        assert time.monotonic() - start < limit
    return out, time.monotonic() - start


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, True),
                                               (True, False)])
def test_loader_order_and_length_match_jax(shuffle, drop_last):
    kw = dict(batch_size=3, shuffle=shuffle, drop_last=drop_last,
              num_workers=3, collate_fn=_collate, seed=4)
    got = pipeline.Loader(_Items(), worker_timeout=10.0, **kw)
    want = jpipeline.Loader(_Items(), worker_timeout=10.0, **kw)
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        batches, _ = _consume(got, 10.0)
        assert batches == list(want) and len(got) == len(want)
        assert len(batches) == len(got)
        flat = [i for b in batches for i in b]
        assert len(flat) == (9 if drop_last else 10) == len(set(flat))


def test_loader_raises_a_workers_error():
    loader = pipeline.Loader(_Items(fail_at=4), batch_size=2, num_workers=2,
                             collate_fn=_collate, worker_timeout=10.0)
    start = time.monotonic()
    with pytest.raises(RuntimeError, match="dataset index 4") as info:
        _consume(loader, 10.0)
    assert isinstance(info.value.__cause__, ValueError)
    assert time.monotonic() - start < 10.0


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_loader_raises_when_every_worker_is_gone():
    class Dies(_Items):
        def __getitem__(self, i):
            raise SystemExit  # not an Exception: the worker thread ends

    loader = pipeline.Loader(Dies(), batch_size=2, num_workers=2,
                             collate_fn=_collate, worker_timeout=10.0)
    start = time.monotonic()
    with pytest.raises(RuntimeError, match="all loader workers exited"):
        _consume(loader, 10.0)
    assert time.monotonic() - start < 2.0  # woken as the workers end
    for t in threading.enumerate():  # their exit is reported in this test
        if t.name.endswith("(worker)"):
            t.join(timeout=2.0)


def test_loader_times_out_without_progress():
    """Item 3 blocks until released: batch 1 (items 2-3) makes no progress
    for the 0.5 s limit."""
    release = threading.Event()
    loader = pipeline.Loader(_Items(block=release), batch_size=2,
                             num_workers=1, collate_fn=_collate,
                             worker_timeout=0.5)
    start = time.monotonic()
    try:
        with pytest.raises(TimeoutError, match="no progress on batch 1"):
            _consume(loader, 10.0)
    finally:
        release.set()
    assert time.monotonic() - start < 5.0


def test_loader_under_thread_stress_keeps_every_sample_in_order():
    """16 workers (more than the cores) over 240 items, with the
    interpreter switching threads as often as it can: every batch comes out
    once, in order, each sample in its place."""
    import sys

    class Jittery(_Items):
        def __getitem__(self, i):
            time.sleep(0.0005 * (i % 3))
            return np.full((2,), i), i

    loader = pipeline.Loader(Jittery(240), batch_size=7, shuffle=True,
                             num_workers=16, collate_fn=_collate, seed=3,
                             worker_timeout=30.0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        batches, _ = _consume(loader, 60.0)
    finally:
        sys.setswitchinterval(interval)
    order = np.arange(240)
    np.random.default_rng(3).shuffle(order)
    assert [i for b in batches for i in b] == order.tolist()


def test_prefetch_on_the_cpu_is_a_plain_copy():
    batches = [{"raw_video": np.full((2, 3), i, np.uint8),
                "label": np.arange(2, dtype=np.int32) + i} for i in range(3)]
    out = list(pipeline.device_prefetch(iter(batches), "cpu"))
    assert len(out) == 3
    for b, o in zip(batches, out):
        for k in b:
            assert isinstance(o[k], torch.Tensor)
            np.testing.assert_array_equal(o[k].numpy(), b[k])
