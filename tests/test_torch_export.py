"""The port's resolution change, serving export and tools against the JAX
package's, on the CPU.

- ``interpolate_pos_encoding``: the JAX package resizes the position table
  with ``jax.image.resize(..., "bicubic")`` (Keys' cubic a = -0.5,
  renormalised edges, antialiased when it shrinks); the port's two weight
  products agree within 1e-5 (fp32 summation order). A TimeSformer at
  another size than its table's: fp32 features within 1e-4 · max|ref|, as
  tests/test_torch_timesformer.py holds them.
- ``serving/export.py``: the ``params.npz`` and ``manifest.json`` of the
  JAX package's ``export_predictor`` for the same weights and arguments,
  but for ``platforms``: the port's programs run on ``["cpu", "cuda"]``
  (tests/test_torch_export_program.py holds them).
- ``tools/export_serving.py`` and ``tools/demo_inference.py`` on tiny
  models.

``load_predictor`` over JAX artifacts of every model type is in
tests/test_torch_serving_archs.py, with the helpers here."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videotransformer_tpu import config as vt_config
from videotransformer_tpu.models.timesformer import TimeSformer as JTimeSformer
from videotransformer_tpu.models.timesformer import (
    interpolate_pos_encoding as jax_interpolate)
from videotransformer_tpu.models.vivit import ViViT as JViViT
from videotransformer_tpu.ops.blocks import ClassificationHead as JHead
from videotransformer_tpu.serving.export import (
    export_predictor as jax_export_predictor)
from videotransformer_tpu_torch.models import convert
from videotransformer_tpu_torch.models.timesformer import (
    TimeSformer, interpolate_pos_encoding)
from videotransformer_tpu_torch.models.vivit import ViViT
from videotransformer_tpu_torch.ops.blocks import ClassificationHead
from videotransformer_tpu_torch.serving.export import export_predictor
from videotransformer_tpu_torch.serving.predictor import load_predictor
from videotransformer_tpu_torch.tools import demo_inference, export_serving

E, CLASSES = 32, 5
TS = dict(img_size=32, patch_size=16, embed_dims=E, num_heads=4,
          num_transformer_layers=2)
VV = dict(img_size=32, patch_size=16, embed_dims=E, num_heads=4,
          num_transformer_layers=2, num_time_transformer_layers=2)
DEMO = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "videotransformer_tpu", "data", "assets", "demo")


# --------------------------------------------------- interpolate_pos_encoding

@pytest.mark.parametrize("side,w,h", [
    (4, 96, 96),   # 4 -> 6 a side: upsampling
    (4, 32, 32),   # 4 -> 2: downsampling, the kernel widened (antialias)
    (4, 96, 48),   # w != h: 6 x 3, in the JAX package's (w0, h0) order
    (14, 448, 448),  # the 448 serving table
    (4, 64, 64)])  # the native size: the table itself
def test_interpolate_pos_encoding_matches_jax(side, w, h):
    pe = np.random.RandomState(side + w + h).randn(
        1, side * side + 1, 24).astype(np.float32)
    npatch = (w // 16) * (h // 16)
    want = np.asarray(jax_interpolate(jnp.asarray(pe), npatch, w, h, 16))
    got = interpolate_pos_encoding(torch.from_numpy(pe), npatch, w, h, 16)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def _jax_params(model, shape, seed=0):
    params = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                 jnp.zeros(shape))["params"]
    rng = np.random.RandomState(seed + 1)
    return jax.tree.map(
        lambda a: np.asarray(a) + rng.randn(*a.shape).astype(np.float32)
        * 0.05, jax.device_get(params))


def _port(model, params):
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           convert.jax_flat_to_state_dict(
                               convert.flatten_tree(params)).items()},
                          strict=True)
    return model.eval()


@pytest.mark.parametrize("attention_type,h,w", [
    ("divided_space_time", 48, 48), ("joint_space_time", 32, 64)])
def test_timesformer_at_another_size_matches_jax(attention_type, h, w):
    """A TimeSformer with a 2x2 table on 3x3 and 2x4 patch grids."""
    jmodel = JTimeSformer(num_frames=2, **TS, attention_type=attention_type,
                          drop_path_rate=0.0)
    params = _jax_params(jmodel, (1, 2, 3, 32, 32))
    model = _port(TimeSformer(num_frames=2, **TS,
                              attention_type=attention_type), params)
    x = np.random.RandomState(3).randn(2, 2, 3, h, w).astype(np.float32)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


# ------------------------------------------------------------------ export

def _models(arch, attention_type, frames=4):
    """(JAX model, port model, JAX head, port head) with the same perturbed
    weights."""
    if arch == "timesformer":
        jmodel = JTimeSformer(num_frames=frames, **TS,
                              attention_type=attention_type,
                              drop_path_rate=0.0)
        model = TimeSformer(num_frames=frames, **TS,
                            attention_type=attention_type)
    else:
        jmodel = JViViT(num_frames=frames, **VV,
                        attention_type=attention_type, drop_path_rate=0.0)
        model = ViViT(num_frames=frames, **VV, attention_type=attention_type)
    params = _jax_params(jmodel, (1, frames, 3, 32, 32))
    jhead = JHead(CLASSES, E)
    hparams = _jax_params(jhead, (1, E), seed=4)
    head = ClassificationHead(CLASSES, E)
    head.load_state_dict({k: torch.from_numpy(v) for k, v in
                          convert.jax_flat_to_state_dict(
                              convert.flatten_tree(hparams)).items()})
    return jmodel, _port(model, params), jhead, head, params, hparams


def _jax_export(path, jmodel, jhead, params, hparams, **kw):
    vt_config.set_attention_backend("xla")
    try:
        jax_export_predictor(path, jmodel, jhead, params, hparams,
                             platforms=("cpu",), **kw)
    finally:
        vt_config.set_attention_backend("auto")


def _read(path):
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "params.npz")) as flat:
        return manifest, {k: flat[k] for k in flat.files}


@pytest.mark.parametrize("arch,attention_type,input_mode", [
    ("timesformer", "divided_space_time", "clips"),
    ("timesformer", "divided_space_time", "raw"),
    ("vivit", "fact_encoder", "clips")])
def test_export_writes_jaxs_params_and_manifest(tmp_path, arch,
                                                attention_type, input_mode):
    jmodel, model, jhead, head, params, hparams = _models(arch,
                                                          attention_type)
    kw = dict(num_frames=4, num_class=CLASSES, img_size=32, n_crops=3,
              buckets=(2, 1), input_mode=input_mode, raw_hw=(40, 48))
    _jax_export(str(tmp_path / "jax"), jmodel, jhead, params, hparams, **kw)
    export_predictor(str(tmp_path / "port"), model, head, **kw)
    want_manifest, want = _read(tmp_path / "jax")
    got_manifest, got = _read(tmp_path / "port")
    assert want_manifest.pop("platforms") == ["cpu"]
    assert got_manifest.pop("platforms") == ["cpu", "cuda"]
    assert got_manifest == want_manifest
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert sorted(f for f in os.listdir(tmp_path / "port")
                  if f.endswith(".pt2")) == ["predict_b1.pt2",
                                             "predict_b2.pt2"]


# ------------------------------------------------------------------- tools

@pytest.fixture
def tiny_tools(monkeypatch):
    """The tools' build_model at D 32 (TimeSformer at 32², 2 layers)."""
    build = lambda arch, num_frames, attention_type=None: TimeSformer(
        num_frames=num_frames, **TS,
        attention_type=attention_type or "divided_space_time")
    monkeypatch.setattr(export_serving, "build_model", build)
    monkeypatch.setattr(demo_inference, "build_model", build)


def _trained(seed=3):
    g = torch.Generator().manual_seed(seed)
    model = TimeSformer(num_frames=4, **TS)
    model.reset_parameters(g)
    head = ClassificationHead(CLASSES, E)
    head.reset_parameters(g)
    return model.eval(), head.eval()


@pytest.mark.parametrize("ckpt_format", ["torch", "port"])
def test_export_serving_tool(tmp_path, tiny_tools, ckpt_format):
    """--ckpt of either format: the artifact serves the checkpoint's
    weights (model and head) at --img_size."""
    model, head = _trained()
    ckpt = str(tmp_path / "ckpt")
    if ckpt_format == "torch":
        convert.save_reference_checkpoint(model, ckpt, head)
    else:
        torch.save({"model": model.state_dict(),
                    "cls_head": head.state_dict()}, ckpt)
    out = str(tmp_path / "artifact")
    export_serving.main(["--out", out, "--ckpt", ckpt, "--ckpt_format",
                         ckpt_format, "--num_frames", "4", "--num_class",
                         str(CLASSES), "--img_size", "48", "--buckets",
                         "2,1", "--dtype", "float32"])
    manifest, _ = _read(out)
    assert manifest["img_size"] == 48 and manifest["buckets"] == [1, 2]
    pred = load_predictor(out, "cpu", num_heads=4, dtype=torch.float32)
    assert pred.model is None and sorted(pred.programs) == [1, 2]
    clips = torch.from_numpy(np.random.RandomState(8).rand(
        2, 3, 4, 3, 48, 48).astype(np.float32))
    with torch.no_grad():
        want = head(model(clips.flatten(0, 1))).reshape(2, 3, -1).mean(1)
    np.testing.assert_allclose(pred(clips.numpy()), want.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_demo_inference_tool(tmp_path, tiny_tools, monkeypatch, capsys):
    """--ckpt (model and head from a reference .pth), --classmap, --device
    cpu: the crop-mean logits of the checkpoint's weights on the clip, and
    the class named by the classmap."""
    model, head = _trained(seed=9)
    ckpt = str(tmp_path / "k.pth")
    convert.save_reference_checkpoint(model, ckpt, head)
    clip = np.random.RandomState(10).rand(3, 4, 3, 32, 32).astype(np.float32)
    monkeypatch.setattr(demo_inference, "load_clip", lambda *a, **k: clip)
    classmap = {f"class_{i}": i for i in range(CLASSES)}
    with open(tmp_path / "classmap.json", "w") as f:
        json.dump(classmap, f)
    logits = demo_inference.main([
        "--video", "unused.mp4", "--num_frames", "4", "--num_class",
        str(CLASSES), "--ckpt", ckpt, "--classmap",
        str(tmp_path / "classmap.json"), "--device", "cpu"])
    with torch.no_grad():
        want = head(model(torch.from_numpy(clip))).reshape(1, 3, -1).mean(1)
    np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    pred = int(want.argmax())
    assert f"prediction: {pred} (class_{pred})" in capsys.readouterr().out


def test_demo_inference_decodes_a_demo_clip():
    """load_clip over a bundled demo mp4 (OpenCV): three 224² crops."""
    pytest.importorskip("cv2")
    clip = demo_inference.load_clip(
        os.path.join(DEMO, "pulse_circle_0.mp4"), 4, 2, (0.45,) * 3,
        (0.225,) * 3, np.random.default_rng(0))
    assert clip.shape == (3, 4, 3, 224, 224) and np.isfinite(clip).all()
