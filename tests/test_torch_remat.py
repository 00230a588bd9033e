"""Activation checkpointing (``-remat``) of the port against the JAX
package's ``nn.remat`` and against the port without it, on the CPU.

- TimeSformer (divided) and ViViT (fact_encoder, joint) with ``remat`` on
  both sides: features and the gradients of sum(features²) against JAX's
  (the port of tests/test_training.py::test_remat_same_outputs_and_grads),
  fp32, rtol 1e-4 on features and the gradients at
  tests/test_torch_kernels_bwd.py's fp32 bounds (summation order only).
- The port with remat against the port without, DropPath 0.1 in training
  mode, two SGD steps from one generator: every parameter and the
  generator's state after them bit-equal. A naive ``checkpoint`` wrap
  (the generator handed to the recompute as it is) fails this: the
  second forward draws other masks and advances the live generator again.
- Two trainer steps with ``remat`` against the JAX trainer with
  ``remat=True`` at tests/test_torch_training.py's fp32 bounds.
- ``-remat True`` with ``-arch mvit``: MaskFeat has no remat, in JAX as
  here, and is built the same.
- A tiny ``single_run`` with ``-remat True -device cpu``: bit-equal to
  the same run without it."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

import jax
import jax.numpy as jnp

import test_torch_training
from test_torch_training import (
    TINY, _fp32_params_close, _run_three_steps)
from videotransformer_tpu.models.timesformer import TimeSformer as JTimeSformer
from videotransformer_tpu.models.vivit import ViViT as JViViT
from videotransformer_tpu.serving.export import flatten_params
from videotransformer_tpu.training import trainer as jtrainer
from videotransformer_tpu_torch import model_pretrain as cli
from videotransformer_tpu_torch.models.convert import jax_flat_to_state_dict
from videotransformer_tpu_torch.models.maskfeat import MaskFeat
from videotransformer_tpu_torch.models.timesformer import TimeSformer
from videotransformer_tpu_torch.models.vivit import ViViT
from videotransformer_tpu_torch.ops import blocks
from videotransformer_tpu_torch.training import trainer as ptrainer

DEMO = "videotransformer_tpu/data/assets/demo"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (JAX class, port class, kwargs, clip frames)
MODELS = {
    "timesformer": (JTimeSformer, TimeSformer,
                    dict(num_frames=2, img_size=32, patch_size=16,
                         embed_dims=32, num_heads=4,
                         num_transformer_layers=2), 2),
    "vivit-fact_encoder": (JViViT, ViViT,
                           dict(num_frames=4, img_size=32, patch_size=16,
                                embed_dims=64, num_heads=4,
                                num_transformer_layers=2,
                                num_time_transformer_layers=2,
                                attention_type="fact_encoder"), 4),
    "vivit-joint": (JViViT, ViViT,
                    dict(num_frames=4, img_size=32, patch_size=16,
                         embed_dims=64, num_heads=4,
                         num_transformer_layers=2,
                         attention_type="joint_space_time"), 4),
    "vivit-divided": (JViViT, ViViT,
                      dict(num_frames=4, img_size=32, patch_size=16,
                           embed_dims=64, num_heads=4,
                           num_transformer_layers=2,
                           attention_type="divided_space_time"), 4),
}


def _clip(frames, n=2, seed=0):
    return np.random.RandomState(seed).rand(n, frames, 3, 32, 32).astype(
        np.float32)


def _to_torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in
            jax_flat_to_state_dict(flatten_params(tree)).items()}


@pytest.mark.parametrize("kind", ["timesformer", "vivit-fact_encoder",
                                  "vivit-joint"])
def test_remat_matches_jax_remat(kind):
    jcls, pcls, kw, frames = MODELS[kind]
    x = _clip(frames)
    jm = jcls(**kw, drop_path_rate=0.0, remat=True)
    params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                             jnp.asarray(x))["params"])
    rng = np.random.RandomState(3)
    params = jax.tree.map(
        lambda a: np.asarray(a) + rng.randn(*a.shape).astype(np.float32)
        * 0.05, params)
    features = lambda p: jm.apply({"params": p}, jnp.asarray(x))
    want = np.asarray(jax.jit(features)(params))
    jgrads = jax.jit(jax.grad(lambda p: (features(p) ** 2).sum()))(params)
    pm = pcls(**kw, drop_path_rate=0.0, remat=True)
    pm.load_state_dict(_to_torch(params), strict=True)
    pm.eval()  # the JAX apply's deterministic=True; remat acts all the same
    assert all(c.remat for c in pm.modules()
               if isinstance(c, blocks.TransformerContainer))
    out = pm(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-4,
                               atol=1e-5)
    (out ** 2).sum().backward()
    want_grads = _to_torch(jgrads)
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   rtol=5e-4, atol=5e-5, err_msg=name)


def _naive(block, x, generator):
    """``torch.utils.checkpoint`` around the block as it is: the recompute
    gets the live generator."""
    return checkpoint(block, x, generator, use_reentrant=False,
                      preserve_rng_state=False)


def _two_sgd_steps(kind, remat):
    """Parameters and the DropPath generator's state after two steps of
    sum(features²) with SGD at lr 0.1, DropPath 0.1, training mode."""
    _, pcls, kw, frames = MODELS[kind]
    model = pcls(**kw, drop_path_rate=0.1, remat=remat)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.train()
    generator = torch.Generator().manual_seed(5)
    x = torch.from_numpy(_clip(frames, n=4, seed=1))
    for _ in range(2):
        loss = (model(x, generator) ** 2).sum()
        model.zero_grad()
        loss.backward()
        with torch.no_grad():
            for p in model.parameters():
                p -= 0.1 * p.grad
    return ([p.detach().clone() for p in model.parameters()],
            generator.get_state())


@pytest.mark.parametrize("wrap", ["port", "naive"])
@pytest.mark.parametrize("kind", ["timesformer", "vivit-fact_encoder",
                                  "vivit-joint", "vivit-divided"])
def test_remat_is_bit_equal_to_without(monkeypatch, kind, wrap):
    plain, plain_state = _two_sgd_steps(kind, remat=False)
    if wrap == "naive":
        monkeypatch.setattr(blocks, "checkpointed", _naive)
    got, state = _two_sgd_steps(kind, remat=True)
    same = (all(torch.equal(a, b) for a, b in zip(got, plain)),
            torch.equal(state, plain_state))
    assert same == ((True, True) if wrap == "port" else (False, False))


def test_remat_wraps_only_while_autograd_records(monkeypatch):
    calls = []
    monkeypatch.setattr(blocks, "checkpointed",
                        lambda *a: calls.append(1) or a[0](*a[1:]))
    _, pcls, kw, frames = MODELS["timesformer"]
    model = pcls(**kw, remat=True)
    model.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(_clip(frames))
    with torch.no_grad():
        model(x)
    with torch.inference_mode():
        model(x)
    assert not calls
    model(x)
    assert len(calls) == 2  # one a block


def _remat_models(mp):
    """test_torch_training's tiny models, with the configs' remat."""
    mp.setattr(jtrainer, "build_model", lambda c: JTimeSformer(
        **TINY, drop_path_rate=0.0, remat=c.remat,
        dtype=jtrainer.model_dtype(c)))
    mp.setattr(ptrainer, "build_model", lambda c: TimeSformer(
        **TINY, drop_path_rate=0.0, remat=c.remat))


def test_trainer_steps_with_remat_match_jax_trainer(monkeypatch):
    """test_torch_training's three steps, both trainers with remat."""
    monkeypatch.setattr(test_torch_training, "_patch_tiny", _remat_models)
    _run_three_steps(monkeypatch, _fp32_params_close, 1e-4, 1e-4,
                     remat=True)


def test_remat_leaves_maskfeat_unchanged():
    """``-remat True -arch mvit`` builds the MaskFeat it builds without
    (JAX trainer.py:65-72 passes no remat to MaskFeat either)."""
    base = dict(objective="supervised", arch="mvit", num_frames=16,
                img_size=224, attention_type="divided_space_time")
    states = []
    for remat in (False, True):
        model = ptrainer.build_model(SimpleNamespace(**base, remat=remat))
        assert isinstance(model, MaskFeat)
        assert not any(isinstance(m, blocks.TransformerContainer)
                       for m in model.modules())
        model.reset_parameters(torch.Generator().manual_seed(0))
        states.append(model.state_dict())
    assert list(states[0]) == list(states[1])
    assert all(torch.equal(states[0][k], states[1][k]) for k in states[0])


def test_single_run_with_remat_equals_without(monkeypatch, tmp_path):
    """-remat True -device cpu on the demo list, a tiny TimeSformer with
    DropPath 0.1: one epoch of three steps, and the last checkpoint's
    weights bit-equal to the same run without -remat."""
    pytest.importorskip("cv2")
    built = []

    def build(c):
        built.append(TimeSformer(
            num_frames=c.num_frames, img_size=c.img_size, embed_dims=64,
            num_heads=4, num_transformer_layers=2, drop_path_rate=0.1,
            remat=c.remat))
        return built[-1]

    monkeypatch.setattr(ptrainer, "build_model", build)
    monkeypatch.chdir(REPO)
    states = []
    for remat in ("False", "True"):
        root = tmp_path / remat
        argv = [
            "-epoch", "1", "-batch_size", "4", "-num_workers", "1",
            "-num_class", "4", "-num_frames", "4", "-frame_interval", "4",
            "-img_size", "32", "-objective", "supervised", "-lr", "0.01",
            "-warmup_epochs", "1", "-root_dir", str(root),
            "-train_data_path", f"{DEMO}/demo_train_list.txt",
            "-classmap_path", f"{DEMO}/demo_classmap.json",
            "-device", "cpu", "-use_fp16", "False", "-remat", remat]
        trainer = cli.single_run(argv)
        assert trainer.global_step == 3
        assert built[-1].transformer_layers.remat == (remat == "True")
        states.append({k: v.clone() for k, v in
                       trainer.model.state_dict().items()})
    assert all(torch.equal(states[0][k], states[1][k]) for k in states[0])
