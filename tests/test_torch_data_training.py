"""The port's trainer on uint8 clips against the JAX package's, and the
port's CLI, on the CPU.

- Three supervised ``raw_video`` steps (the tiny TimeSformer and the
  parameter hand-over of tests/test_torch_training.py, ``drop_path_rate``
  0): each trainer augments the uint8 batch on its device; the port gets
  the JAX step's augment draws (aug_key = split(split(key)[1])[0],
  trainer.py:325, 386), and with mixup the JAX step's mixup draws from the
  key after it. Tolerances as that file's fp32 steps: loss and grad norm
  rtol 1e-4, parameters rtol 5e-4 / atol 5e-5 (the augment's pixels agree
  to 5e-3 of 255, tests/test_torch_device_augment.py, far inside them).
- The eval step on uint8 clips, CenterCrop and ThreeCrop: the same top-k
  counts.
- ``fit`` over ``KineticsDataModule`` on the bundled demo clips with the
  device augment, a tiny model.
- The CLI: ``parse_args`` has the JAX CLI's flags and defaults but for
  ``-device`` and the deliberate bool-flag deviation; ``single_run`` trains
  one tiny epoch on the demo list; unported flags raise.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import model_pretrain as jax_cli
from test_torch_device_augment import jax_augment_draws
from test_torch_training import (
    LR, WD, _fp32_params_close, _jax_mixup_draws, _pair)
from videotransformer_tpu.parallel.mesh import shard_batch
from videotransformer_tpu_torch import model_pretrain as cli
from videotransformer_tpu_torch.models import convert
from videotransformer_tpu_torch.models.timesformer import TimeSformer
from videotransformer_tpu_torch.training import data_module as dm
from videotransformer_tpu_torch.training import trainer as ptrainer

DEMO = "videotransformer_tpu/data/assets/demo"
UPDATE_TOL = 5e-3  # measured worst 5.2e-4


def _raw_batch(n=8, h=40, w=52, seed=0):
    rng = np.random.RandomState(seed)
    return {"raw_video": rng.randint(0, 256, (n, 2, h, w, 3)).astype(
        np.uint8), "label": (np.arange(n) % 10).astype(np.int32)}


@pytest.mark.parametrize("over", [{}, {"mixup": True},
                                  {"auto_augment": "rand-m9",
                                   "aug_scale": (0.5, 1.0)}],
                         ids=["jitter", "jitter_mixup", "rand_augment"])
def test_three_raw_video_steps_match_jax_trainer(monkeypatch, over):
    jt, pt = _pair(monkeypatch, **over)
    start = convert.flatten_tree(jax.device_get(jt.params))
    batch = _raw_batch()
    jbatch = shard_batch(jt.mesh, batch)
    recipe = {"scale": tuple(over.get("aug_scale", (0.08, 1.0))),
              "auto_augment": "auto_augment" in over}
    for step in range(3):
        key = jax.random.fold_in(jt.base_key, step)
        mix_key = jax.random.split(key)[1]
        aug_key = jax.random.split(mix_key)[0]
        draws = jax_augment_draws(aug_key, 8, 40, 52, **recipe)
        monkeypatch.setattr(ptrainer, "draw_augment",
                            lambda *a, d=draws, **k: d)
        if jt.mixup_fn is not None:
            mix = _jax_mixup_draws(mix_key, 32, 32, jt.mixup_fn)
            pt.mixup_fn.sample_draws = lambda *a, d=mix: d
        jt.params, jt.opt_state, js = jt._train_step(
            jt.params, jt.opt_state, jbatch, key, jnp.float32(LR),
            jnp.float32(WD))
        ps = pt.train_step(batch, LR, WD)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(ps[k]), float(js[k]),
                                       rtol=1e-4, err_msg=f"{k} {step}")
        assert (int(ps["top1"]), int(ps["top5"])) == \
            (int(js["top1"]), int(js["top5"])), step
    want = convert.flatten_tree(jax.device_get(jt.params))
    got = convert.flatten_tree(pt.params_tree())
    assert sorted(got) == sorted(want)
    worst = 0.0
    for k in want:
        sl = slice(0, None)
        if k.endswith("attn/qkv/bias"):  # the key third: a zero gradient
            third = want[k].shape[0] // 3
            np.testing.assert_allclose(got[k][third:2 * third],
                                       want[k][third:2 * third], rtol=0,
                                       atol=6 * LR, err_msg=k)
            sl = np.r_[0:third, 2 * third:3 * third]
        if not recipe["auto_augment"]:
            _fp32_params_close(got[k][sl], want[k][sl], start[k][sl], k)
            continue
        # RandAugment: a few pixels land on the other side of a Posterize,
        # Solarize or Equalize step (tests/test_torch_device_augment.py),
        # so elements may part by more than rounding; each tensor's update
        # over the three steps within UPDATE_TOL of its norm, and every
        # element within 6·lr
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=6 * LR,
                                   err_msg=k)
        dw, dg = want[k][sl] - start[k][sl], got[k][sl] - start[k][sl]
        worst = max(worst, np.linalg.norm(dg - dw) / np.linalg.norm(dw))
    assert worst <= UPDATE_TOL, worst


@pytest.mark.parametrize("n_crops", [1, 3])
def test_raw_eval_step_matches_jax_trainer(monkeypatch, n_crops):
    jt, pt = _pair(monkeypatch)
    batch = _raw_batch(5, h=48, w=64, seed=1)
    batch["label"] = np.array([3, 1, 4, 1, 5], np.int32)
    padded = jt._pad_eval_batch(batch, n_crops)
    want = jt._eval_step(jt.params, shard_batch(jt.mesh, padded), n_crops)
    for b in (batch, padded):
        got = pt.eval_step(b, n_crops)
        assert int(got["bs"]) == int(want["bs"]) == 5
        assert (int(got["top1"]), int(got["top5"])) == \
            (int(want["top1"]), int(want["top5"]))


def _demo_configs(**over):
    args = cli.parse_args([
        "-epoch", "1", "-batch_size", "4", "-num_workers", "2",
        "-num_class", "4", "-num_frames", "4", "-frame_interval", "4",
        "-img_size", "32", "-objective", "supervised", "-lr", "0.01",
        "-warmup_epochs", "1", "-root_dir", "unused",
        "-train_data_path", f"{DEMO}/demo_train_list.txt",
        "-classmap_path", f"{DEMO}/demo_classmap.json",
        "-device", "cpu", "-use_fp16", "False", "-log_interval", "1"])
    for k, v in over.items():
        setattr(args, k, v)
    return args


def _tiny(monkeypatch):
    monkeypatch.setattr(ptrainer, "build_model", lambda c: TimeSformer(
        num_frames=c.num_frames, img_size=c.img_size, embed_dims=64,
        num_heads=4, num_transformer_layers=2, drop_path_rate=0.1))


@pytest.mark.parametrize("device_augment", [True, False])
def test_fit_over_the_kinetics_data_module(monkeypatch, tmp_path,
                                           device_augment):
    """12 demo clips, batch 4: three train steps, 12 clips validated and
    tested (uint8 clips and the device eval recipe, or host transforms and
    host ThreeCrop), a last checkpoint."""
    pytest.importorskip("cv2")
    _tiny(monkeypatch)
    ann = f"{DEMO}/demo_train_list.txt"
    cfg = _demo_configs(device_augment=device_augment)
    data = dm.KineticsDataModule(cfg, ann, ann, ann)
    assert data.device_eval == device_augment
    batch = next(iter(data.train_loader()))
    assert ("raw_video" in batch) == device_augment
    tr = ptrainer.VideoTransformerTrainer(cfg, "cpu", do_eval=True,
                                          do_test=True,
                                          ckpt_dir=str(tmp_path))
    tr.fit(data, max_epochs=1)
    assert tr.global_step == 3
    assert tr.val_meter.total == tr.test_meter.total == 12
    assert os.path.exists(tmp_path / "last_checkpoint")


def test_mim_data_module_recipes(monkeypatch):
    """mim: uint8 clips and collate_mim_raw with the device augment, host
    HOG without it (and with -device_hog, the clip before Normalize)."""
    pytest.importorskip("cv2")
    ann = f"{DEMO}/demo_train_list.txt"
    for over, keys in (
            ({"device_augment": True}, {"raw_video"}),
            ({}, {"video", "hog"}),
            ({"device_hog": True}, {"video", "raw"})):
        cfg = _demo_configs(objective="mim", batch_size=2, **over)
        batch = next(iter(dm.KineticsDataModule(cfg, ann).train_loader()))
        assert keys <= set(batch) and {"mask", "cube_marker",
                                       "cube_count"} <= set(batch), over


# ------------------------------------------------------------ the CLI

REQUIRED = ["-epoch", "1", "-batch_size", "2", "-num_class", "4",
            "-num_frames", "4", "-frame_interval", "4", "-lr", "0.1",
            "-root_dir", "r", "-train_data_path", "t.txt"]


def test_parse_args_matches_the_jax_cli():
    """Every flag of the JAX CLI, with its default; the port adds -device.
    Bool flags parse by value in the port, where argparse's type=bool reads
    any non-empty string, "False" too, as True (the reference's fault (b),
    which the JAX CLI keeps)."""
    want, got = vars(jax_cli.parse_args(REQUIRED)), vars(
        cli.parse_args(REQUIRED))
    assert got.pop("device") == "cuda"
    assert got == want
    flags = ["-use_fp16", "False", "-device_augment", "False", "-mixup",
             "False", "-fused_adamw", "False"]
    j = jax_cli.parse_args(REQUIRED + flags)
    p = cli.parse_args(REQUIRED + flags)
    assert j.use_fp16 and j.device_augment and j.mixup and j.fused_adamw
    assert not (p.use_fp16 or p.device_augment or p.mixup or p.fused_adamw)
    p = cli.parse_args(REQUIRED + ["-use_fp16", "True", "-mixup", "1"])
    assert p.use_fp16 is True and p.mixup is True
    with pytest.raises(SystemExit):
        cli.parse_args(REQUIRED + ["-use_fp16", "maybe"])


@pytest.mark.parametrize("flags,what", [
    # -tp is ported (tests/test_torch_parallel*.py); beside it -sp is not
    (["-sp", "2"], "A11"), (["-tp", "2", "-sp", "2"], "A11"),
    (["-pp", "2"], "A11"),
    (["-scan_layers", "True"], "not ported")])
def test_unported_flags_raise(tmp_path, flags, what):
    argv = REQUIRED[:-4] + ["-root_dir", str(tmp_path), "-train_data_path",
                            "t.txt"] + flags
    with pytest.raises(NotImplementedError, match=what):
        cli.single_run(argv)
    assert not os.listdir(tmp_path)  # refused before anything is written


def test_exp_tag_is_cut_with_a_hash():
    args = cli.parse_args(REQUIRED)
    assert cli.exp_tag(args).startswith("objective_mim_arch_timesformer_")
    args.pretrain_pth = "x" * 300
    tag = cli.exp_tag(args)
    assert len(tag) == 199 and tag[188] == "_"


def test_single_run_trains_one_tiny_epoch(monkeypatch, tmp_path):
    """-device cpu -device_augment True on the demo list: three steps of
    batch 4, validation and test on the device recipe, a log and a last
    checkpoint; -resume then starts at the end."""
    pytest.importorskip("cv2")
    _tiny(monkeypatch)
    argv = [
        "-epoch", "1", "-batch_size", "4", "-num_workers", "2",
        "-num_class", "4", "-num_frames", "4", "-frame_interval", "4",
        "-img_size", "32", "-objective", "supervised", "-lr", "0.01",
        "-warmup_epochs", "1", "-root_dir", str(tmp_path),
        "-train_data_path", f"{DEMO}/demo_train_list.txt",
        "-val_data_path", f"{DEMO}/demo_train_list.txt",
        "-test_data_path", f"{DEMO}/demo_train_list.txt",
        "-classmap_path", f"{DEMO}/demo_classmap.json",
        "-log_interval", "1", "-device", "cpu", "-device_augment", "True",
        "-use_fp16", "False"]
    trainer = cli.single_run(argv)
    assert trainer.device == torch.device("cpu")
    assert trainer.configs.lr == pytest.approx(0.01 * 4 / 256)
    assert trainer.global_step == 3
    assert trainer.val_meter.total == trainer.test_meter.total == 12
    (run,) = (tmp_path / "results").iterdir()
    assert (run / "ckpt" / "last_checkpoint").exists()
    log = (run / "log" / "train.log").read_text()
    assert "step 2/3" in log and "of current test epoch" in log
    resumed = cli.single_run(argv + ["-resume"])
    assert (resumed.epoch, resumed.global_step) == (1, 3)
