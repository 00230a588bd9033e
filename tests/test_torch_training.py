"""The port's supervised train step against the JAX package's trainer.

A tiny divided space-time TimeSformer (D 64, 4 heads, 2 layers, 2 frames at
32²: spatial rows of 5 tokens, temporal rows of 2) and a 10-class head. The
JAX ``VideoTransformerTrainer`` (its ``build_model`` patched to the tiny
model, as tests/test_training.py does) and the port's trainer start from the
same parameters, carried across by the port's converter, and take three
steps on the same numpy batch; each step's loss, grad norm and top-1/top-5
counts, and every updated parameter (converted back), must agree.

Tolerances: fp32 rtol 1e-4 on loss and grad norm and 5e-4 on parameters,
with atol 5e-5 (5% of one AdamW step at lr 1e-3): the JAX trainer on its
8-device CPU mesh takes the fused flat AdamW group for its small leaves,
which agrees with the per-tensor form only up to fp32 re-association
(tests/test_training.py:134), and the batch's gradient is summed across the
mesh in another order. AdamW moves an element by about lr whatever the size
of its gradient, so where the exact gradient is zero the step follows the
rounding noise: the key third of each qkv bias (attention is invariant to a
shift of every key by one vector) is held only to 6·lr, the most two runs
can part in three steps. In bf16 compute with fp32 parameters the JAX
package runs its XLA path on the CPU and the port the kernels' plain
versions, which round to bf16 at other points: loss within 5e-3 and grad
norm within 3e-2 relative, and each tensor's update over the three steps
within 0.3 of its norm (AdamW turns the rounding flips of small gradients
into whole steps; measured worst 0.2, median 0.08).

DropPath and mixup are random: jax.random and torch never agree, so the
parity runs use ``drop_path_rate=0`` and feed the port the JAX trainer's
mixup draws; DropPath parity is checked on one block with the same masks
fed to both packages (tests/test_torch_training_parts.py, with the other
parts: mixup, schedules, metrics, the optimizer)."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec

from videotransformer_tpu.models import TimeSformer as JTimeSformer
from videotransformer_tpu.parallel.mesh import shard_batch
from videotransformer_tpu.training import trainer as jtrainer
from videotransformer_tpu.training.optimizer import no_decay_mask
from videotransformer_tpu_torch.models import convert
from videotransformer_tpu_torch.models.timesformer import TimeSformer
from videotransformer_tpu_torch.training import trainer as ptrainer

TINY = dict(num_frames=2, img_size=32, patch_size=16, embed_dims=64,
            num_heads=4, num_transformer_layers=2)
LR, WD = 1e-3, 0.05


def _configs(**over):
    cfg = dict(
        objective="supervised", arch="timesformer",
        attention_type="divided_space_time", num_class=10, num_frames=2,
        img_size=32, optim_type="adamw", lr=LR, lr_schedule="cosine",
        warmup_epochs=1, min_lr=1e-6, weight_decay=WD, weight_decay_end=WD,
        clip_grad=1.0, seed=0, mixup=False, eval_metrics="finetune",
        use_fp16=False, drop_path_rate=0.0)
    cfg.update(over)
    return SimpleNamespace(**cfg)


def _patch_tiny(mp):
    mp.setattr(jtrainer, "build_model", lambda c: JTimeSformer(
        **TINY, drop_path_rate=0.0, dtype=jtrainer.model_dtype(c)))
    mp.setattr(ptrainer, "build_model",
               lambda c: TimeSformer(**TINY, drop_path_rate=0.0))


def _batch(n=8, seed=0):
    rng = np.random.RandomState(seed)
    return {"video": rng.rand(n, 2, 3, 32, 32).astype(np.float32),
            "label": (np.arange(n) % 10).astype(np.int32)}


def _jax_mixup_draws(key, h, w, mix):
    """The draws JAX's Mixup takes from the train step's key
    (trainer.py:325, mixup.py:68-74, 41-43)."""
    _, mix_key = jax.random.split(key)
    k_prob, k_switch, k_lam_mix, k_lam_cut, k_box = jax.random.split(
        mix_key, 5)
    ky, kx = jax.random.split(k_box)
    return {"do_mix": bool(jax.random.uniform(k_prob) < mix.mix_prob),
            "use_cutmix": bool(jax.random.uniform(k_switch)
                               < mix.switch_prob),
            "lam_mixup": float(jax.random.beta(k_lam_mix, mix.mixup_alpha,
                                               mix.mixup_alpha)),
            "lam_cutmix": float(jax.random.beta(k_lam_cut, mix.cutmix_alpha,
                                                mix.cutmix_alpha)),
            "cy": int(jax.random.randint(ky, (), 0, h)),
            "cx": int(jax.random.randint(kx, (), 0, w))}


def _pair(mp, **over):
    """A JAX trainer and a port trainer from the same (perturbed: every
    temporal_fc nonzero) parameters."""
    _patch_tiny(mp)
    cfg = _configs(**over)
    jt = jtrainer.VideoTransformerTrainer(cfg, ckpt_dir=None, do_eval=True,
                                          do_test=True)
    rng = np.random.RandomState(1)
    params = jax.tree.map(
        lambda a: np.asarray(a) + rng.randn(*a.shape).astype(np.float32)
        * 0.02, jax.device_get(jt.params))
    jt.params = jt._place_params(params)
    # the optimizer's step count starts on one device and comes back from
    # the step replicated over the mesh; placed so from the start, the step
    # compiles once instead of twice
    replicated = NamedSharding(jt.mesh, PartitionSpec())
    jt.opt_state = jax.tree.map(
        lambda a: jax.device_put(a, replicated)
        if len(a.sharding.device_set) == 1 else a, jt.opt_state)
    pt = ptrainer.VideoTransformerTrainer(_configs(**over), "cpu",
                                          do_eval=True, do_test=True,
                                          params=params)
    return jt, pt


@pytest.fixture(scope="module")
def fp32_pair():
    """One fp32 pair for the tests that only read it; the tiny build_model
    patches end with the fixture's set-up."""
    with pytest.MonkeyPatch.context() as mp:
        return _pair(mp)


def _flat(tree):
    return convert.flatten_tree(jax.device_get(tree))


def _run_three_steps(mp, param_tol, loss_tol, norm_tol, **over):
    jt, pt = _pair(mp, **over)
    init = _flat(jt.params)
    batch = _batch()
    jbatch = shard_batch(jt.mesh, batch)
    for step in range(3):
        key = jax.random.fold_in(jt.base_key, step)
        if jt.mixup_fn is not None:
            draws = _jax_mixup_draws(key, 32, 32, jt.mixup_fn)
            pt.mixup_fn.sample_draws = lambda *a, d=draws: d
        jt.params, jt.opt_state, js = jt._train_step(
            jt.params, jt.opt_state, jbatch, key, jnp.float32(LR),
            jnp.float32(WD))
        ps = pt.train_step(batch, LR, WD)
        for k, tol in (("loss", loss_tol), ("grad_norm", norm_tol)):
            np.testing.assert_allclose(float(ps[k]), float(js[k]),
                                       rtol=tol, err_msg=f"{k} {step}")
        assert (int(ps["top1"]), int(ps["top5"])) == \
            (int(js["top1"]), int(js["top5"])), step
    want, got = _flat(jt.params), _flat(pt.params_tree())
    assert sorted(want) == sorted(got)
    for k in want:
        key_bias = k.endswith("attn/qkv/bias")
        sl = slice(0, None)
        if key_bias:  # the key third, compared apart (module doc)
            third = want[k].shape[0] // 3
            np.testing.assert_allclose(
                got[k][third:2 * third], want[k][third:2 * third], rtol=0,
                atol=6 * LR, err_msg=k)
            sl = np.r_[0:third, 2 * third:3 * third]
        param_tol(got[k][sl], want[k][sl], init[k][sl], k)


def _fp32_params_close(got, want, init, key):
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-5, err_msg=key)


def _bf16_updates_close(got, want, init, key):
    err = np.linalg.norm((got - init) - (want - init)) / \
        np.linalg.norm(want - init)
    assert err <= 0.3, (key, err)


def test_three_train_steps_match_jax_trainer(monkeypatch):
    _run_three_steps(monkeypatch, _fp32_params_close, 1e-4, 1e-4)


def test_three_train_steps_with_mixup_match_jax_trainer(monkeypatch):
    _run_three_steps(monkeypatch, _fp32_params_close, 1e-4, 1e-4,
                     mixup=True)


def test_three_bf16_train_steps_match_jax_trainer(monkeypatch):
    _run_three_steps(monkeypatch, _bf16_updates_close, 5e-3, 3e-2,
                     use_fp16=True)


@pytest.mark.parametrize("n_crops", [1, 3])
def test_eval_matches_jax_trainer(fp32_pair, n_crops):
    """5 clips padded to the 8-device mesh with label -1 rows: the same
    top-k counts, and only the 5 real clips counted."""
    jt, pt = fp32_pair
    rng = np.random.RandomState(2)
    batch = {"video": rng.rand(5 * n_crops, 2, 3, 32, 32).astype(np.float32),
             "label": np.array([3, 1, 4, 1, 5], np.int32)}
    padded = jt._pad_eval_batch(batch, n_crops)
    want = jt._eval_step(jt.params, shard_batch(jt.mesh, padded), n_crops)
    got = pt.eval_step(padded, n_crops)
    assert int(got["bs"]) == int(want["bs"]) == 5
    assert (int(got["top1"]), int(got["top5"])) == \
        (int(want["top1"]), int(want["top5"]))


def test_no_decay_groups_match_jax(fp32_pair):
    """The torch-name rule gives the flax-path rule's groups, leaf by leaf;
    time_embed (3-D, no keyword) is decayed, pos_embed and cls_token not."""
    jt, pt = fp32_pair
    params = jax.device_get(jt.params)
    mask = convert.flatten_tree(jax.tree.map(np.asarray,
                                              no_decay_mask(params)))
    for top in ("model", "cls_head"):
        flat = convert.flatten_tree(params[top])
        # one torch name per flax path, in the same order
        names = convert.jax_flat_to_state_dict(flat)
        for key, name in zip(flat, names):
            assert pt.optimizer.no_decay[f"{top}.{name}"] == \
                bool(mask[f"{top}/{key}"]), key
    nd = pt.optimizer.no_decay
    assert not nd["model.time_embed"]
    assert nd["model.pos_embed"] and nd["model.cls_token"]
    assert nd["model.norm.weight"] and nd["cls_head.cls_head.bias"]
    assert not nd["model.transformer_layers.layers.0.ffns.0.layers.0.0.weight"]


def test_converter_round_trips_the_trainer_tree(fp32_pair):
    jt, _ = fp32_pair
    tree = jax.device_get(jt.params)
    back = convert.state_dicts_to_trainer_tree(
        *convert.trainer_tree_to_state_dicts(tree))
    want, got = _flat(tree), _flat(back)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_linear_prob_trains_only_the_head(monkeypatch):
    _patch_tiny(monkeypatch)
    pt = ptrainer.VideoTransformerTrainer(
        _configs(eval_metrics="linear_prob"), "cpu")
    before = {k: v.clone() for k, v in pt.model.state_dict().items()}
    head = pt.cls_head.cls_head.weight.detach().clone()
    pt.train_step(_batch(), 1e-2, WD)
    for k, v in pt.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert not torch.equal(head, pt.cls_head.cls_head.weight)
    assert all(n.startswith("cls_head.") for n in pt.optimizer.params)


class _Loader(list):

    def set_epoch(self, epoch):
        self.epoch = epoch


class _DataModule:

    def __init__(self, batch, val, test):
        self.batch, self.val, self.test = batch, val, test

    def train_loader(self):
        return _Loader([self.batch, self.batch])

    def val_loader(self):
        return _Loader([self.val])

    def test_loader(self):
        return _Loader([self.test])


def test_fit_checkpoints_and_resume(monkeypatch, tmp_path):
    """fit over two epochs writes last and best checkpoints; a trainer
    resumed from the first epoch's checkpoint takes the second epoch to the
    same parameters, moments and step count (DropPath on: its draws follow
    the global step)."""
    _patch_tiny(monkeypatch)
    monkeypatch.setattr(ptrainer, "build_model",
                        lambda c: TimeSformer(**TINY, drop_path_rate=0.2))
    rng = np.random.RandomState(7)
    labels = np.array([1, 2, 3, -1], np.int32)
    val = {"video": rng.rand(4, 2, 3, 32, 32).astype(np.float32),
           "label": labels}
    test = {"video": rng.rand(12, 2, 3, 32, 32).astype(np.float32),
            "label": labels}  # three crops
    data = _DataModule(_batch(), val, test)

    make = lambda name, **kw: ptrainer.VideoTransformerTrainer(
        _configs(**kw), "cpu", ckpt_dir=str(tmp_path / name), do_eval=True,
        do_test=True)
    full = make("full")
    full.fit(data, max_epochs=2)
    assert full.global_step == 4 and full.epoch == 1
    assert "last_checkpoint" in os.listdir(tmp_path / "full")
    part = make("part")
    part.fit(data, max_epochs=1)

    resumed = make("resumed")
    resumed.load_checkpoint(str(tmp_path / "part" / "last_checkpoint"))
    assert (resumed.epoch, resumed.global_step) == (1, 2)
    resumed.fit(data, max_epochs=2)
    assert resumed.global_step == 4
    for (k, a), b in zip(full.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    for n in full.optimizer.params:
        torch.testing.assert_close(full.optimizer.mu[n],
                                   resumed.optimizer.mu[n], rtol=0, atol=0)
    if full.max_top1_acc > 0:
        assert any("_top1_acc_" in n for n in os.listdir(tmp_path / "full"))


def _flax_shapes(model, cfg):
    """{flax path: shape} of the JAX model's parameters, traced, not made."""
    clip = jax.ShapeDtypeStruct(
        (1, cfg.num_frames, 3, cfg.img_size, cfg.img_size), jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), clip)
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                shapes["params"])[0]}


def _port_flax_shapes(model):
    """{flax path: shape} of the port's parameters under the converter's
    names and layouts (zero-stride arrays: nothing is allocated)."""
    out = {}
    for name, t in model.state_dict().items():
        prefix, leaf = convert._state_name_to_flax(name)
        arr = np.lib.stride_tricks.as_strided(
            np.zeros(1, np.float32), shape=tuple(t.shape),
            strides=(0,) * t.dim())
        leaf, arr = convert._leaf_to_flax(leaf, arr)
        out[f"{prefix}/{leaf}" if prefix else leaf] = arr.shape
    return out


@pytest.mark.parametrize("arch,attention_type", [
    ("vivit", "fact_encoder"), ("vivit", "joint_space_time"),
    ("vivit", "divided_space_time"), ("timesformer", "joint_space_time"),
    ("timesformer", "space_only")])
def test_other_archs_build_the_jax_trainers_models(arch, attention_type):
    """build_model gives, for every architecture and attention type, the
    model the JAX trainer's build_model gives (ViViT-B or TimeSformer-B at
    16 frames of 32²): the same parameters under the converter, name by
    name and shape by shape, DropPath at the configured rate. Their steps
    against the JAX trainer: tests/test_torch_vivit_training.py and, for
    the TimeSformer types' forward, tests/test_torch_joint.py."""
    cfg = _configs(arch=arch, attention_type=attention_type, num_frames=16,
                   drop_path_rate=0.2)
    with torch.device("meta"):
        port = ptrainer.build_model(cfg)
    assert _port_flax_shapes(port) == _flax_shapes(
        jtrainer.build_model(cfg), cfg)
    rates = {m.rate for m in port.modules() if hasattr(m, "rate")}
    assert max(rates) == pytest.approx(0.2)


@pytest.mark.parametrize("what", ["arch"])
def test_unported_options_still_raise(what):
    """What the port still refuses: an unknown arch, as the JAX trainer
    does. (The pretrained-weight import and other resolutions are ported:
    tests/test_torch_checkpoint*.py and test_torch_export.py.)"""
    with pytest.raises(ValueError, match="swin"):
        ptrainer.build_model(_configs(**{what: "swin"}))
