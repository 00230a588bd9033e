"""The port's supervised train step on ViViT against the JAX package's
trainer: three steps with ``fact_encoder`` and with ``joint_space_time``,
and the eval forward.

A tiny ViViT (D 64, 4 heads, 2 spatial and 2 temporal layers, 4 frames of
32², tube 2) and a 10-class head. The JAX ``VideoTransformerTrainer`` (its
``build_model`` patched to the tiny model, as tests/test_torch_training.py
does) and the port's trainer start from the same parameters, carried
across by the port's converter, and take three steps on the same numpy
batch of 8 clips; each step's loss, grad norm and top-1/top-5 counts, and
every updated parameter (converted back), must agree. The port's
``build_model`` builds the ViViT the JAX package's builds for every
attention type (tests/test_torch_training.py).

Tolerances and method are tests/test_torch_training.py's: fp32 rtol 1e-4
on loss and grad norm, parameters rtol 5e-4 with atol 5e-5, the key third
of each qkv bias (attention is invariant to a shift of every key, so its
exact gradient is zero and AdamW follows the rounding noise) held to 6·lr;
DropPath off (jax.random and torch never draw alike). The same holds for
any element whose gradient at some step is below 10x AdamW's eps (1e-8):
its update is about (g / eps)·lr, so the fp32 summation order of g (about
1e-9 in these sums) moves it by a tenth of a step. Those elements (one of
the joint model's 98304 patch-embedding weights, whose first gradient is
3e-9 against a median of 1.5e-3) are held to 6·lr like the key bias."""

from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec

from videotransformer_tpu.models import ViViT as JViViT
from videotransformer_tpu.parallel.mesh import shard_batch
from videotransformer_tpu.training import trainer as jtrainer
from videotransformer_tpu_torch.models import convert
from videotransformer_tpu_torch.models.vivit import ViViT
from videotransformer_tpu_torch.training import trainer as ptrainer

TINY = dict(num_frames=4, img_size=32, patch_size=16, embed_dims=64,
            num_heads=4, num_transformer_layers=2,
            num_time_transformer_layers=2)
LR, WD = 1e-3, 0.05
ADAM_EPS = 1e-8  # the optimizer's


def _configs(kind):
    return SimpleNamespace(
        objective="supervised", arch="vivit", attention_type=kind,
        num_class=10, num_frames=4, img_size=32, optim_type="adamw", lr=LR,
        lr_schedule="cosine", warmup_epochs=1, min_lr=1e-6,
        weight_decay=WD, weight_decay_end=WD, clip_grad=1.0, seed=0,
        mixup=False, eval_metrics="finetune", use_fp16=False,
        drop_path_rate=0.0)


def _batch(n=8, seed=0):
    rng = np.random.RandomState(seed)
    return {"video": rng.rand(n, 4, 3, 32, 32).astype(np.float32),
            "label": (np.arange(n) % 10).astype(np.int32)}


def _flat(tree):
    return convert.flatten_tree(jax.device_get(tree))


@pytest.fixture(scope="module", params=["fact_encoder", "joint_space_time"])
def vivit_pair(request):
    """A JAX trainer and a port trainer of one attention type from the same
    (perturbed) parameters."""
    kind = request.param
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer, "build_model", lambda c: JViViT(
            **TINY, attention_type=kind, drop_path_rate=0.0,
            dtype=jtrainer.model_dtype(c)))
        mp.setattr(ptrainer, "build_model", lambda c: ViViT(
            **TINY, attention_type=kind, drop_path_rate=0.0))
        jt = jtrainer.VideoTransformerTrainer(_configs(kind), ckpt_dir=None,
                                              do_eval=True, do_test=True)
        rng = np.random.RandomState(1)
        params = jax.tree.map(
            lambda a: np.asarray(a) + rng.randn(*a.shape).astype(np.float32)
            * 0.02, jax.device_get(jt.params))
        jt.params = jt._place_params(params)
        # the step count placed replicated from the start: one compile
        replicated = NamedSharding(jt.mesh, PartitionSpec())
        jt.opt_state = jax.tree.map(
            lambda a: jax.device_put(a, replicated)
            if len(a.sharding.device_set) == 1 else a, jt.opt_state)
        pt = ptrainer.VideoTransformerTrainer(_configs(kind), "cpu",
                                              do_eval=True, do_test=True,
                                              params=params)
    return jt, pt


def test_three_train_steps_match_jax_trainer(vivit_pair):
    jt, pt = vivit_pair
    batch = _batch()
    jbatch = shard_batch(jt.mesh, batch)
    tiny = {}  # elements whose gradient fell below 10·eps at some step
    for step in range(3):
        key = jax.random.fold_in(jt.base_key, step)
        jt.params, jt.opt_state, js = jt._train_step(
            jt.params, jt.opt_state, jbatch, key, jnp.float32(LR),
            jnp.float32(WD))
        ps = pt.train_step(batch, LR, WD)
        for mod, top in ((pt.model, "model"), (pt.cls_head, "head")):
            for n, p in mod.named_parameters():
                small = (p.grad.abs() < 10 * ADAM_EPS).float().numpy()
                key_ = (top, n)
                tiny[key_] = np.maximum(tiny.get(key_, 0.0), small)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(ps[k]), float(js[k]), rtol=1e-4,
                                       err_msg=f"{k} {step}")
        assert (int(ps["top1"]), int(ps["top5"])) == \
            (int(js["top1"]), int(js["top5"])), step
    want, got = _flat(jt.params), _flat(pt.params_tree())
    assert sorted(want) == sorted(got)
    noisy = _flat(convert.state_dicts_to_trainer_tree(
        {n: m for (top, n), m in tiny.items() if top == "model"},
        {n: m for (top, n), m in tiny.items() if top == "head"}))
    for k in want:
        loose = noisy[k] > 0
        if k.endswith("attn/qkv/bias"):  # the key third (module doc)
            third = want[k].shape[0] // 3
            loose[third:2 * third] = True
        np.testing.assert_allclose(got[k][loose], want[k][loose], rtol=0,
                                   atol=6 * LR, err_msg=k)
        np.testing.assert_allclose(got[k][~loose], want[k][~loose],
                                   rtol=5e-4, atol=5e-5, err_msg=k)


@pytest.mark.parametrize("n_crops", [1, 3])
def test_eval_matches_jax_trainer(vivit_pair, n_crops):
    """5 clips padded to the 8-device mesh with label -1 rows (4 in 8 of
    them for three crops): the same top-k counts, only the real clips
    counted."""
    jt, pt = vivit_pair
    rng = np.random.RandomState(2)
    batch = {"video": rng.rand(5 * n_crops, 4, 3, 32, 32).astype(np.float32),
             "label": np.array([3, 1, 4, 1, 5], np.int32)}
    padded = jt._pad_eval_batch(batch, n_crops)
    want = jt._eval_step(jt.params, shard_batch(jt.mesh, padded), n_crops)
    got = pt.eval_step(padded, n_crops)
    assert int(got["bs"]) == int(want["bs"]) == 5
    assert (int(got["top1"]), int(got["top5"])) == \
        (int(want["top1"]), int(want["top5"]))
