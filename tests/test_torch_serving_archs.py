"""The port's ``load_predictor`` over JAX serving artifacts of all six
model types (TimeSformer divided, joint and space-only; ViViT
fact_encoder, joint and divided), whose manifest names no model, and of a
32² TimeSformer exported for 64² requests, against the JAX
``ExportedPredictor``'s StableHLO programs on the CPU: fp32 logits within
1e-4 · max|ref|, as tests/test_torch_serving.py holds them."""

import numpy as np
import pytest
import torch

from test_torch_export import _jax_export, _models
from videotransformer_tpu.serving.export import ExportedPredictor
from videotransformer_tpu_torch.serving.predictor import load_predictor

CLASSES = 5
TYPES = [("timesformer", "divided_space_time"),
         ("timesformer", "joint_space_time"), ("timesformer", "space_only"),
         ("vivit", "fact_encoder"), ("vivit", "joint_space_time"),
         ("vivit", "divided_space_time")]


@pytest.mark.parametrize("arch,attention_type", TYPES)
def test_load_predictor_serves_every_jax_artifact(tmp_path, arch,
                                                  attention_type):
    """The manifest names no model: the port reads its type from the
    parameter names and serves what the JAX program serves."""
    jmodel, _, jhead, _, params, hparams = _models(arch, attention_type)
    path = str(tmp_path / "artifact")
    _jax_export(path, jmodel, jhead, params, hparams, num_frames=4,
                num_class=CLASSES, img_size=32, buckets=(2,))
    clips = np.random.RandomState(6).rand(2, 3, 4, 3, 32, 32).astype(
        np.float32)
    want = ExportedPredictor(path)(clips)
    pred = load_predictor(path, "cpu", num_heads=4, dtype=torch.float32)
    assert (type(pred.model).__name__.lower(), pred.model.attention_type) \
        == (arch, attention_type)
    got = pred(clips)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_load_predictor_serves_a_larger_size_than_the_table(tmp_path):
    """A 32² model exported for 64² requests (as tools/export_serving.py
    does with --img_size): its table resized on every forward in both."""
    jmodel, _, jhead, _, params, hparams = _models("timesformer",
                                                   "divided_space_time")
    path = str(tmp_path / "artifact")
    _jax_export(path, jmodel, jhead, params, hparams, num_frames=4,
                num_class=CLASSES, img_size=64, buckets=(1,))
    clips = np.random.RandomState(7).rand(1, 3, 4, 3, 64, 64).astype(
        np.float32)
    want = ExportedPredictor(path)(clips)
    pred = load_predictor(path, "cpu", num_heads=4, dtype=torch.float32)
    assert pred.model.patch_embed.num_patches == 4
    got = pred(clips)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
