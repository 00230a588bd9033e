"""The port's FFmpeg encoder (``videotransformer_tpu_torch/native/
videoenc.*``) and its demo-asset tool against the JAX package's, on the CPU.

- ``write_video``: the port's and the JAX package's encoders, both built
  from the same source against this machine's FFmpeg, write the same bytes
  for the same frames; the port's decoder reads the clip back at the
  frames' length and size, within 8 of 255 on average of the frames: the
  MPEG-4 encoder at its default rate is lossy (2.4 on the sliding bar, 5.4
  on the rotating checkerboard, with libavcodec 59).
- ``tools/make_demo_assets.py``: the port's twin writes the 12 clips, the
  list and the class map byte for byte as the repository's tool does, and
  as the committed demo assets are.
- A failed build raises ``EncoderBuildError`` with the compiler's output.

Where this machine cannot build the encoder (no FFmpeg headers) the tests
that encode skip and say why.
"""

import filecmp
import importlib.util
import os

import numpy as np
import pytest

import jax  # noqa: F401  (the JAX package's modules import it)

from videotransformer_tpu.native import videoenc as jvenc
from videotransformer_tpu_torch.native import videoenc
from videotransformer_tpu_torch.native.videodec import NativeVideoReader
from videotransformer_tpu_torch.tools import make_demo_assets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "videotransformer_tpu", "data", "assets", "demo")
MEAN_ABS_TOL = 8.0


@pytest.fixture(scope="module")
def encoder():
    try:
        videoenc.get_lib()
    except videoenc.EncoderBuildError as e:
        pytest.skip(f"the native encoder does not build here: "
                    f"{e.output.strip().splitlines()[-1:]}")


def _jax_tool():
    """The repository's tools/make_demo_assets.py (not a package)."""
    spec = importlib.util.spec_from_file_location(
        "make_demo_assets_jax", os.path.join(REPO, "tools",
                                             "make_demo_assets.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("cls,seed,frames,fps", [(0, 0, 40, 25),
                                                 (3, 2, 9, 12)])
def test_write_video_matches_jax_bytes(encoder, tmp_path, cls, seed, frames,
                                       fps):
    clip = make_demo_assets.make_clip(cls, seed)[:frames]
    port, jax_path = str(tmp_path / "port.mp4"), str(tmp_path / "jax.mp4")
    videoenc.write_video(port, clip, fps)
    jvenc.write_video(jax_path, clip, fps)
    with open(port, "rb") as a, open(jax_path, "rb") as b:
        assert a.read() == b.read()
    reader = NativeVideoReader(port)
    assert (len(reader), reader.height, reader.width) == clip.shape[:3]
    got = reader.get_batch(np.arange(frames))
    reader.close()
    assert np.abs(got.astype(np.int32) - clip).mean() <= MEAN_ABS_TOL


def test_demo_assets_tool_matches_jax_and_the_committed_clips(encoder,
                                                              tmp_path):
    rows = make_demo_assets.main([str(tmp_path / "port")])
    _jax_tool().main(str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "port"))
    assert len(rows) == 12 and names == sorted(os.listdir(tmp_path / "jax"))
    assert len([n for n in names if n.endswith(".mp4")]) == 12
    for name in names:
        port = str(tmp_path / "port" / name)
        assert filecmp.cmp(port, str(tmp_path / "jax" / name),
                           shallow=False), name
        assert filecmp.cmp(port, os.path.join(DEMO, name), shallow=False), \
            name


def test_write_video_refuses_odd_sizes(tmp_path):
    with pytest.raises(ValueError, match="even"):
        videoenc.write_video(str(tmp_path / "x.mp4"),
                             np.zeros((2, 7, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="T, H, W, 3"):
        videoenc.write_video(str(tmp_path / "x.mp4"),
                             np.zeros((2, 8, 8), np.uint8))


def test_build_reports_the_compiler(monkeypatch, tmp_path):
    """No g++: the build raises; a g++ that fails: its output is in the
    error."""
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(videoenc.EncoderBuildError, match="g\\+\\+ not found"):
        videoenc.build(str(tmp_path / "b1"))
    fake = tmp_path / "bin" / "g++"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'fatal error: libavcodec/avcodec.h' "
                    ">&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(fake.parent))
    with pytest.raises(videoenc.EncoderBuildError,
                       match="libavcodec/avcodec.h") as err:
        videoenc.build(str(tmp_path / "b2"))
    assert "libavcodec" in err.value.output
    assert not os.path.exists(tmp_path / "b2" / videoenc.LIB_NAME)
