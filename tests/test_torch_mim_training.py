"""The port's MaskFeat (mim) train step against the JAX package's trainer,
and its HOG targets and cube masks, on the CPU (the supervised MViT step is
in tests/test_torch_mvit_training.py, with these helpers).

Both trainers build the depth-4 MaskFeat of tests/test_mim_training.py
(widths 96/192/192/384, two q-pool stages) through a patched
``build_model``, at 4 frames of 32² (mask grid 2x2), and start from the same
parameters (the JAX initialisation perturbed from a numpy seed) carried
across by the port's converter; the JAX trainer runs on a one-device mesh.
Three AdamW steps (per-parameter clip 1.0) on the same batch: with ``hog``
targets, and with ``raw`` clips whose HOG targets each trainer computes on
its device at the cube-center frames.

Tolerances, fp32: loss and grad norm rtol 1e-4 per step. Parameters: the
update of each tensor over the steps within 1e-3 of its norm, and every
element within 6·lr of the JAX one. AdamW moves an element by about lr a
step whatever the size of its gradient, so an element whose gradient is
rounding noise (the JAX trainer's fused flat AdamW group and the gradient
sums agree with the port's only up to fp32 re-association) follows the
noise, and 6·lr is the most two runs can part in three steps. Each per-head
key LayerNorm bias (``norm_k``) is all such elements (shifting every key by
one vector leaves the softmax as it is, so its exact gradient is 0): it is
held to the 6·lr bound alone. HOG: 1e-5 absolute on 0-255 integer frames
(the orientation bins agree exactly there). Masks: bit-equal under the same
numpy seed.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videotransformer_tpu.data import hog as jhog
from videotransformer_tpu.data import mask_generator as jmask
from videotransformer_tpu.models.maskfeat import MaskFeat as JMaskFeat
from videotransformer_tpu.parallel.mesh import create_mesh, shard_batch
from videotransformer_tpu.training import trainer as jtrainer
from videotransformer_tpu_torch.data import hog, mask_generator
from videotransformer_tpu_torch.models import convert
from videotransformer_tpu_torch.models.maskfeat import MaskFeat
from videotransformer_tpu_torch.training import trainer as ptrainer

DEPTH4 = dict(depth=4, embed_dim_mul=((1, 2.0), (3, 2.0)),
              atten_head_mul=((1, 2.0), (3, 2.0)),
              pool_q_stride_size=((1, 1, 2, 2), (3, 1, 2, 2)),
              feature_dim=2 * 2 * 2 * 3 * 9)
LR, WD = 1e-3, 0.05


def _configs(**over):
    cfg = dict(objective="mim", arch="mvit", num_class=10, num_frames=4,
               img_size=32, optim_type="adamw", clip_grad=1.0, seed=0,
               mixup=False, eval_metrics="finetune", use_fp16=False,
               layer_decay=0.75)
    cfg.update(over)
    return SimpleNamespace(**cfg)


def _pair(mp, **over):
    mp.setattr(jtrainer, "build_model", lambda c: JMaskFeat(
        img_size=c.img_size, num_frames=c.num_frames, **DEPTH4,
        dtype=jtrainer.model_dtype(c)))
    mp.setattr(ptrainer, "build_model", lambda c: MaskFeat(
        img_size=c.img_size, num_frames=c.num_frames, **DEPTH4))
    jt = jtrainer.VideoTransformerTrainer(
        _configs(**over), mesh=create_mesh(devices=jax.devices()[:1]))
    rng = np.random.RandomState(1)
    params = jax.tree.map(
        lambda a: np.asarray(a) + rng.randn(*a.shape).astype(np.float32)
        * 0.02, jax.device_get(jt.params))
    jt.params = jt._place_params(params)
    pt = ptrainer.VideoTransformerTrainer(_configs(**over), "cpu",
                                          params=params)
    return jt, pt, convert.flatten_tree(params)


def _mim_batch(with_hog):
    rng = np.random.RandomState(0)
    video = rng.rand(2, 4, 3, 32, 32).astype(np.float32)
    markers = np.zeros((2, 8, 2), np.int32)
    markers[0, :2] = [[0, 1], [1, 1]]  # center frames 1 and 3
    markers[1, 0] = [0, 2]             # center frame 2
    batch = {"video": video,
             "mask": (rng.rand(2, 2, 2, 2) > 0.3).astype(np.int32),
             "cube_marker": markers, "cube_count": np.array([2, 1], np.int32)}
    if with_hog:
        batch["hog"] = rng.rand(2, 4, 2, 2, 108).astype(np.float32)
    else:
        batch["raw"] = np.floor(video * 255).astype(np.float32)
    return batch


def _flat(tree):
    return convert.flatten_tree(jax.device_get(tree))


def _check_params(jt, pt, init, tensor_tol=1e-3):
    want, got = _flat(jt.params), _flat(pt.params_tree())
    assert sorted(want) == sorted(got) == sorted(init)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=6 * LR,
                                   err_msg=k)
        if k.endswith("norm_k/bias"):
            continue
        dw, dg = want[k] - init[k], got[k] - init[k]
        norm = np.linalg.norm(dw)
        if norm == 0:  # not updated (a frozen decoder, an unused token)
            np.testing.assert_array_equal(dg, dw, err_msg=k)
        else:
            assert np.linalg.norm(dg - dw) <= tensor_tol * norm, k


@pytest.mark.parametrize("with_hog", [True, False])
def test_three_mim_steps_match_jax_trainer(monkeypatch, with_hog):
    jt, pt, init = _pair(monkeypatch)
    assert pt.cls_head is None and "cls_head" not in pt.params_tree()
    batch = _mim_batch(with_hog)
    jbatch = shard_batch(jt.mesh, batch)
    for step in range(3):
        key = jax.random.fold_in(jt.base_key, step)
        jt.params, jt.opt_state, js = jt._train_step(
            jt.params, jt.opt_state, jbatch, key, jnp.float32(LR),
            jnp.float32(WD))
        ps = pt.train_step(batch, LR, WD)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(ps[k]), float(js[k]), rtol=1e-4,
                                       err_msg=f"{k} {step}")
    _check_params(jt, pt, init)


def test_mim_raw_video_step_matches_jax_trainer(monkeypatch):
    """A ``raw_video`` mim step: each trainer augments the uint8 clips with
    the mim recipe (crop scale 0.5-1, flip; no jitter and no RandAugment
    whatever the configs say, the reference's fault (a) at JAX
    trainer.py:345, which the port keeps) and takes its HOG targets from
    the augmented pixels. The port gets the JAX step's augment draws
    (aug_key = split(split(key)[1])[0], trainer.py:325, 339). Tolerances as
    the steps above, except each tensor's update, within 1e-2 of its norm:
    the two augments' pixels agree to 5e-3, and AdamW's first step turns
    the gradient differences of near-zero elements into whole lr steps
    (measured 1.06e-3)."""
    from test_torch_device_augment import jax_augment_draws

    jt, pt, init = _pair(monkeypatch, auto_augment="rand-m9")
    batch = _mim_batch(with_hog=False)
    del batch["video"], batch["raw"]
    batch["raw_video"] = np.random.RandomState(3).randint(
        0, 256, (2, 4, 40, 52, 3)).astype(np.uint8)
    key = jax.random.fold_in(jt.base_key, 0)
    aug_key, _ = jax.random.split(jax.random.split(key)[1])
    draws = jax_augment_draws(aug_key, 2, 40, 52, scale=(0.5, 1.0),
                              color=(0, 0, 0, 0))
    monkeypatch.setattr(ptrainer, "draw_augment", lambda *a, **k: draws)
    jt.params, jt.opt_state, js = jt._train_step(
        jt.params, jt.opt_state, shard_batch(jt.mesh, batch), key,
        jnp.float32(LR), jnp.float32(WD))
    ps = pt.train_step(batch, LR, WD)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(ps[k]), float(js[k]), rtol=1e-4,
                                   err_msg=k)
    _check_params(jt, pt, init, tensor_tol=1e-2)


def test_hog_matches_jax_and_numpy():
    frames = np.random.RandomState(2).randint(
        0, 256, (3, 48, 64, 3)).astype(np.float32)
    want = np.asarray(jhog.batched_hog_targets(jnp.asarray(frames)))
    got = hog.batched_hog_targets(torch.from_numpy(frames)).numpy()
    assert got.shape == want.shape == (3, 3, 4, 108)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for f, g in zip(frames, got):
        host = hog.extract_hog_features_np(f)
        np.testing.assert_array_equal(host, jhog.extract_hog_features_np(f))
        np.testing.assert_allclose(g, host, rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        hog.extract_hog_features(torch.from_numpy(frames[0])).numpy(), got[0],
        rtol=0, atol=0)


def test_cube_masks_match_jax_under_one_seed():
    ours = mask_generator.CubeMaskGenerator(
        rng=np.random.default_rng(11))
    theirs = jmask.CubeMaskGenerator(rng=np.random.default_rng(11))
    markers = []
    for _ in range(20):
        (m1, c1), (m2, c2) = ours(), theirs()
        np.testing.assert_array_equal(m1, m2)
        assert c1 == c2 and m1.shape == (8, 14, 14) and m1.sum() > 0
        markers.append(c1)
    for a, b in zip(mask_generator.pad_cube_marker(markers),
                    jmask.pad_cube_marker(markers)):
        np.testing.assert_array_equal(a, b)
