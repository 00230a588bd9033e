"""The port's FFmpeg decoder (``videotransformer_tpu_torch/native``) and the
readers' choice of backend, on the CPU.

- ``NativeVideoReader`` against the JAX package's, both built from the same
  source against this machine's FFmpeg: bit-equal on every demo clip, at
  short edge 0, 128 and 256, over sorted, reversed and repeated indices,
  with the same length and fps.
- The native reader against the port's OpenCV reader at the JAX package's
  bounds (tests/test_data.py::test_native_decoder_matches_cv2): a mean
  abs difference below 4 of 255 (chroma upsampling and the YUV -> RGB
  rounding differ), the next frame a worse match, and unsorted indices back
  in request order.
- A failed build: ``backend="native"`` raises with the compiler's output;
  ``backend="auto"`` gives way to OpenCV once and prints one line naming
  the error. The JAX package's ``auto`` raises at every open instead (its
  known fault (e), ROADMAP), which the last test holds.

``decode_backend`` (imported by test_torch_data.py and test_torch_serving.py)
makes both packages' default path decode with one backend: ``cv2`` with the
JAX package's native reader switched off and the port's ``auto`` set to
OpenCV, ``native`` with neither patched (both ``auto`` -> native).
"""

import glob
import os
import stat

import numpy as np
import pytest

import jax  # noqa: F401  (the JAX package's modules import it)

from videotransformer_tpu.data import video_reader as jvr
from videotransformer_tpu.native import videodec as jvd
from videotransformer_tpu_torch.data import video_reader
from videotransformer_tpu_torch.data.video_reader import (
    CV2Reader, VideoReader)
from videotransformer_tpu_torch.native import videodec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "videotransformer_tpu", "data", "assets", "demo")
CLIPS = sorted(os.path.basename(p)
               for p in glob.glob(os.path.join(DEMO, "*.mp4")))


@pytest.fixture(params=["cv2", "native"])
def decode_backend(request, monkeypatch):
    if request.param == "cv2":
        pytest.importorskip("cv2")
        monkeypatch.setattr(jvr, "_load_native", lambda: None)
        monkeypatch.setattr(video_reader, "_auto", ("cv2", None))
    else:
        backend, error = video_reader.auto_backend()
        if backend != "native":
            pytest.skip(f"the native decoder does not build here: {error}")
        assert jvr._load_native() is jvd
    return request.param


@pytest.fixture
def native():
    """The port's library, built here (FFmpeg's headers and g++ present)."""
    backend, error = video_reader.auto_backend()
    if backend != "native":
        pytest.skip(f"the native decoder does not build here: {error}")


def test_twelve_demo_clips():
    assert len(CLIPS) == 12


@pytest.mark.parametrize("short_edge", [0, 128, 256])
@pytest.mark.parametrize("clip", CLIPS)
def test_native_reader_is_bit_equal_to_jax(native, clip, short_edge):
    path = os.path.join(DEMO, clip)
    want = jvd.NativeVideoReader(path, short_edge=short_edge)
    got = videodec.NativeVideoReader(path, short_edge=short_edge)
    try:
        assert len(got) == len(want) == 40
        assert got.fps == want.fps == 25.0
        assert (got.height, got.width) == (want.height, want.width)
        if short_edge:
            assert min(got.height, got.width) == short_edge
        n = len(got)
        for idx in (np.linspace(0, n - 1, 8).astype(np.int64),
                    np.arange(n)[::-1], [7, 7, 0, n - 1, n - 1, 7]):
            frames = got.get_batch(idx)
            assert frames.shape == (len(idx), got.height, got.width, 3)
            assert frames.dtype == np.uint8
            np.testing.assert_array_equal(frames, want.get_batch(idx))
    finally:
        got.close()
        want.close()


@pytest.mark.parametrize("clip", CLIPS)
def test_native_reader_against_cv2_at_the_jax_tests_bounds(native, clip):
    path = os.path.join(DEMO, clip)
    vr = VideoReader(path, backend="native")
    cv = VideoReader(path, backend="cv2")
    try:
        assert (vr.backend, cv.backend) == ("native", "cv2")
        assert len(vr) == len(cv) and vr.fps == cv.fps
        idx = np.linspace(0, len(vr) - 1, 8).astype(np.int64)
        b_native, b_cv = vr.get_batch(idx), cv.get_batch(idx)
        assert b_native.shape == b_cv.shape
        diff = np.abs(b_native.astype(int) - b_cv.astype(int))
        assert diff.mean() < 4.0, diff.mean()
        nxt = cv.get_batch([idx[3] + 1])[0].astype(int)
        d_same = np.abs(b_native[3].astype(int) - b_cv[3].astype(int)).mean()
        d_next = np.abs(b_native[3].astype(int) - nxt).mean()
        assert d_same < d_next, (d_same, d_next)
        shuffled = vr.get_batch(idx[::-1].copy())
        np.testing.assert_array_equal(shuffled, b_native[::-1])
    finally:
        vr.close()
        cv.close()


def test_decord_init_passes_its_threads_on(native):
    reader = video_reader.DecordInit(num_threads=2)(
        os.path.join(DEMO, CLIPS[0]))
    try:
        assert reader.backend == "native" and len(reader) == 40
        one = VideoReader(os.path.join(DEMO, CLIPS[0]), num_threads=1)
        idx = [0, 13, 39]
        np.testing.assert_array_equal(reader.get_batch(idx),
                                      one.get_batch(idx))
        one.close()
    finally:
        reader.close()
    with pytest.raises(ValueError, match="not one of"):
        VideoReader(os.path.join(DEMO, CLIPS[0]), backend="decord")


def _compiler(bin_dir, body):
    """A ``g++`` on ``bin_dir`` that runs the shell ``body``."""
    os.makedirs(bin_dir, exist_ok=True)
    path = os.path.join(bin_dir, "g++")
    with open(path, "w") as f:
        f.write(f"#!/bin/sh\n{body}\n")
    os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)


ERROR = "videodec.cpp:22:10: fatal error: libavcodec/avcodec.h: No such file"


@pytest.fixture
def failing_build(tmp_path, monkeypatch):
    """A compiler that fails as one without FFmpeg's headers does, a build
    directory in tmp_path, and no choice of ``auto`` made yet."""
    pytest.importorskip("cv2")
    _compiler(str(tmp_path / "bin"), f"echo '{ERROR}' >&2\nexit 1")
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    monkeypatch.setattr(videodec, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(video_reader, "_auto", None)
    return tmp_path


def test_native_raises_with_the_compilers_output(failing_build, capsys):
    path = os.path.join(DEMO, CLIPS[0])
    with pytest.raises(videodec.DecoderBuildError) as e:
        VideoReader(path, backend="native")
    assert ERROR in str(e.value) and "g++ failed (1)" in str(e.value)
    assert not (failing_build / "build" / videodec.LIB_NAME).exists()
    reader = VideoReader(path)  # auto
    assert reader.backend == "cv2" and reader.get_batch([0]).shape[0] == 1
    reader.close()
    assert video_reader.auto_backend() == ("cv2", ERROR)
    VideoReader(path).close()
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and lines[0].endswith(ERROR), lines


def test_auto_gives_way_without_a_compiler(tmp_path, monkeypatch, capsys):
    pytest.importorskip("cv2")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(videodec, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(video_reader, "_auto", None)
    with pytest.raises(videodec.DecoderBuildError, match="g\\+\\+ not found"):
        videodec.get_lib()
    reader = VideoReader(os.path.join(DEMO, CLIPS[0]))
    assert reader.backend == "cv2"
    reader.close()
    assert "g++ not found on PATH" in capsys.readouterr().out


def test_build_is_redone_when_the_source_is_newer(native, tmp_path,
                                                  monkeypatch):
    """An up-to-date library is not rebuilt; one older than the source
    is, by the compiler on PATH."""
    build_dir = str(tmp_path / "build")
    so = videodec.build(build_dir)
    assert videodec.build(build_dir) == so
    old = os.path.getmtime(videodec.SRC) - 10
    os.utime(so, (old, old))
    _compiler(str(tmp_path / "bin"), "echo rebuilt >&2\nexit 3")
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    with pytest.raises(videodec.DecoderBuildError, match="rebuilt"):
        videodec.build(build_dir)


def test_cv2_reader_is_the_jax_cv2_backend():
    pytest.importorskip("cv2")
    path = os.path.join(DEMO, CLIPS[3])
    got, want = CV2Reader(path, short_edge=128), jvr._CV2Backend(
        path, short_edge=128)
    idx = [39, 0, 5, 5]
    np.testing.assert_array_equal(got.get_batch(idx), want.get_batch(idx))
    got.close()
    want.close()


def test_jax_auto_raises_where_the_port_gives_way(failing_build,
                                                  monkeypatch):
    """Known reference fault (e): the JAX package's ``auto`` guards only the
    import of its binding (video_reader.py:28-40); the build runs when a
    reader opens, with ``check=True`` (videodec.py:22-28), so without a
    working compiler every open raises. The port's ``auto`` opens with
    OpenCV."""
    monkeypatch.setattr(jvd, "_SO", str(failing_build / "jax" / "lib.so"))
    monkeypatch.setattr(jvd, "_lib", None)
    monkeypatch.setattr(jvr, "_NATIVE_TRIED", False)
    monkeypatch.setattr(jvr, "_NATIVE_LIB", None)
    path = os.path.join(DEMO, CLIPS[0])
    for _ in range(2):
        with pytest.raises(Exception) as e:
            jvr.VideoReader(path)
        assert "returned non-zero exit status 1" in str(e.value)
    reader = VideoReader(path)
    assert reader.backend == "cv2"
    reader.close()
