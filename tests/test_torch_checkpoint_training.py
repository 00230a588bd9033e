"""The port's checkpoint exchange and the trainer's import routes against
the JAX package's, on the CPU (the surgery, loaders and merge are in
tests/test_torch_checkpoint.py, with the helpers these tests share).

- The ``.pth`` both ways: ``save_reference_checkpoint`` writes the keys and
  values of the JAX package's ``save_torch_checkpoint`` and the JAX import
  reads them back; the JAX file imports into the port.
- The trainer's ``pretrain_pth`` routes against the JAX trainer's, from the
  same initial parameters: every parameter after the import equal. The
  port's own checkpoint stands for the JAX trainer's orbax directory.
- The CLI: one ``-pretrain_pth ... -device cpu`` run.

Exact throughout: the values only move, they are never computed."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import orbax.checkpoint as ocp

from test_torch_checkpoint import (
    DEPTH4, E, TS, VV, _assert_dicts_equal, _jax_params, _port_flat,
    _port_from, _port_model, _r, _route_file, _save, _vit_sd)
from videotransformer_tpu.models import convert as jconvert
from videotransformer_tpu.models.maskfeat import MaskFeat as JMaskFeat
from videotransformer_tpu.models.timesformer import TimeSformer as JTimeSformer
from videotransformer_tpu.models.vivit import ViViT as JViViT
from videotransformer_tpu.parallel.mesh import create_mesh
from videotransformer_tpu.training import trainer as jtrainer
from videotransformer_tpu_torch import model_pretrain as cli
from videotransformer_tpu_torch.models import convert
from videotransformer_tpu_torch.models.maskfeat import MaskFeat
from videotransformer_tpu_torch.models.timesformer import TimeSformer
from videotransformer_tpu_torch.ops.blocks import ClassificationHead
from videotransformer_tpu_torch.training import trainer as ptrainer

DEMO = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "videotransformer_tpu", "data", "assets", "demo")

# ------------------------------------------------------ the .pth both ways

PTH_CASES = [("timesformer", "divided_space_time"),
             ("vivit", "fact_encoder"), ("mvit", None)]


def _head(seed):
    rng = np.random.RandomState(seed)
    return {"cls_head": {"kernel": _r(rng, E, 10), "bias": _r(rng, 10)}}


@pytest.mark.parametrize("arch,attention_type", PTH_CASES)
def test_reference_pth_of_the_port_is_jaxs(tmp_path, arch, attention_type):
    """save_reference_checkpoint writes the keys and values of the JAX
    package's save_torch_checkpoint for the same weights, and the JAX
    package's import of it gives those weights back."""
    params = _jax_params(arch, attention_type)
    head = None if arch == "mvit" else _head(2)
    model = _port_from(arch, attention_type, params)
    port_head = None
    if head is not None:
        port_head = ClassificationHead(10, E)
        port_head.load_state_dict({k: torch.from_numpy(v) for k, v in
                                   convert.jax_flat_to_state_dict(
                                       convert.flatten_tree(head)).items()})
    ours, theirs = str(tmp_path / "port.pth"), str(tmp_path / "jax.pth")
    convert.save_reference_checkpoint(model, ours, port_head)
    jconvert.save_torch_checkpoint(
        params, theirs, attention_type or "divided_space_time",
        cls_head=head, arch="mvit" if arch == "mvit" else "timesformer")
    a = torch.load(ours, weights_only=True)["state_dict"]
    b = torch.load(theirs, weights_only=True)["state_dict"]
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].dtype == b[k].dtype == torch.float32
        assert torch.equal(a[k], b[k]), k
    fresh = _jax_params(arch, attention_type, seed=21)
    if arch == "mvit":
        got = jconvert.init_maskfeat_from_kinetics_pretrain(fresh, ours)
    else:
        got = jconvert.init_from_kinetics_pretrain(fresh, ours,
                                                   attention_type)
    _assert_dicts_equal(convert.flatten_tree(jax.device_get(got)),
                        convert.flatten_tree(params))


@pytest.mark.parametrize("arch,attention_type", PTH_CASES)
def test_jax_pth_imports_into_the_port(tmp_path, arch, attention_type):
    """The JAX package's save_torch_checkpoint file into a port model of
    other initial weights: every leaf equal to the JAX tree's; a
    MaskFeat's import has no missing and no unexpected key, the others
    only the head's keys unexpected."""
    params = _jax_params(arch, attention_type)
    path = str(tmp_path / "jax.pth")
    jconvert.save_torch_checkpoint(
        params, path, attention_type or "divided_space_time",
        cls_head=None if arch == "mvit" else _head(2),
        arch="mvit" if arch == "mvit" else "timesformer")
    model = _port_from(arch, attention_type,
                       _jax_params(arch, attention_type, seed=21))
    if arch == "mvit":
        keys = convert.init_maskfeat_from_kinetics_pretrain(model, path)
        assert keys == ([], [])
    else:
        keys = convert.init_from_kinetics_pretrain(model, path)
        assert keys == ([], ["cls_head.weight", "cls_head.bias"])
    _assert_dicts_equal(_port_flat(model), convert.flatten_tree(params))


# ------------------------------------------------------- the trainer's routes

def _cfg(**over):
    cfg = dict(objective="supervised", arch="timesformer",
               attention_type="divided_space_time", num_class=10,
               num_frames=2, img_size=32, optim_type="adamw", lr=1e-3,
               lr_schedule="cosine", warmup_epochs=1, min_lr=1e-6,
               weight_decay=0.05, weight_decay_end=0.05, clip_grad=1.0,
               seed=0, mixup=False, eval_metrics="finetune", use_fp16=False,
               drop_path_rate=0.0, layer_decay=0.75)
    cfg.update(over)
    if cfg["arch"] == "vivit":
        cfg["num_frames"] = 4
    if cfg["arch"] == "mvit":
        cfg["num_frames"] = 4
    return SimpleNamespace(**cfg)


def _patch_builds(mp):
    def jbuild(c):
        dtype = jtrainer.model_dtype(c)
        if c.objective == "mim" or c.arch == "mvit":
            return JMaskFeat(img_size=c.img_size, num_frames=c.num_frames,
                             **DEPTH4, dtype=dtype)
        if c.arch == "vivit":
            return JViViT(**VV, attention_type=c.attention_type,
                          drop_path_rate=0.0, dtype=dtype)
        return JTimeSformer(**TS, attention_type=c.attention_type,
                            drop_path_rate=0.0, dtype=dtype)

    def pbuild(c):
        if c.objective == "mim" or c.arch == "mvit":
            return MaskFeat(img_size=c.img_size, num_frames=c.num_frames,
                            **DEPTH4)
        return _port_model(c.arch, c.attention_type)

    mp.setattr(jtrainer, "build_model", jbuild)
    mp.setattr(ptrainer, "build_model", pbuild)


def _jax_trainer(cfg):
    return jtrainer.VideoTransformerTrainer(
        cfg, mesh=create_mesh(devices=jax.devices()[:1]))


def test_port_checkpoint_is_recognised_before_the_unwrap(tmp_path):
    """The port trainer's own checkpoint: the generic unwrap would take
    its ``model`` entry and ``replace_state_dict`` would then cut 9
    characters off every key; the trainer recognises the layout first and
    imports its parameters whole."""
    cfg = _cfg(arch="timesformer", attention_type="divided_space_time")
    with pytest.MonkeyPatch.context() as mp:
        _patch_builds(mp)
        src = ptrainer.VideoTransformerTrainer(cfg, "cpu", seed=5)
        path = str(tmp_path / "last_checkpoint")
        src.save_checkpoint(path)
        payload = convert.read_checkpoint(path)
        assert ptrainer.is_port_checkpoint(payload)
        mangled = convert.replace_state_dict(
            convert.load_torch_state_dict(payload))
        assert not set(mangled) & set(src.model.state_dict())
        dst = ptrainer.VideoTransformerTrainer(
            SimpleNamespace(**{**vars(cfg), "pretrain_pth": path}), "cpu")
    assert dst.pretrained_keys == ([], [])
    for k, v in src.model.state_dict().items():
        assert torch.equal(dst.model.state_dict()[k], v), k
    assert not torch.equal(dst.cls_head.cls_head.weight,
                           src.cls_head.cls_head.weight)  # head ignored


TRAINER_ROUTES = [
    ("own checkpoint", dict(arch="mvit", attention_type=None)),
    ("maskfeat", dict(arch="mvit", attention_type=None)),
    ("imagenet", dict(arch="timesformer")),
    ("imagenet", dict(arch="vivit", attention_type="fact_encoder")),
    ("kinetics", dict(arch="timesformer")),
    ("unknown", dict(arch="timesformer"))]


@pytest.mark.parametrize("route,over", TRAINER_ROUTES,
                         ids=[f"{r}-{o['arch']}" for r, o in TRAINER_ROUTES])
def test_trainer_routes_match_the_jax_trainer(monkeypatch, tmp_path, route,
                                              over):
    """``pretrain_pth`` through each route of the JAX trainer: the port
    trainer, started from the JAX trainer's initial parameters, ends its
    import with the JAX trainer's parameters, leaf for leaf. The port's
    own checkpoint stands for the JAX trainer's orbax directory (the same
    weights in each); an unknown ``weights_from`` raises TypeError in
    both."""
    _patch_builds(monkeypatch)
    weights_from = {"unknown": "somewhere"}.get(route, route)
    cfg = _cfg(**over, weights_from=weights_from)
    init = jax.device_get(_jax_trainer(cfg).params)
    arch, att = cfg.arch, cfg.attention_type
    if route == "own checkpoint":
        mim_cfg = _cfg(**over, objective="mim")
        mim_tree = {"model": _jax_params("mvit", None, seed=31)}
        jax_path = str(tmp_path / "orbax")
        ocp.PyTreeCheckpointer().save(jax_path, {"params": mim_tree})
        port_path = str(tmp_path / "last_checkpoint")
        ptrainer.VideoTransformerTrainer(
            mim_cfg, "cpu", params=mim_tree).save_checkpoint(port_path)
    else:
        port_path = jax_path = _route_file(
            {"imagenet": "vit", "unknown": "vit"}.get(route, route), arch,
            att, tmp_path)
    if route == "unknown":
        with pytest.raises(TypeError, match="not support"):
            _jax_trainer(_cfg(**over, weights_from=weights_from,
                              pretrain_pth=jax_path))
        with pytest.raises(TypeError, match="not support"):
            ptrainer.VideoTransformerTrainer(
                _cfg(**over, weights_from=weights_from,
                     pretrain_pth=port_path), "cpu", params=init)
        return
    jt = _jax_trainer(_cfg(**over, weights_from=weights_from,
                           pretrain_pth=jax_path))
    pt = ptrainer.VideoTransformerTrainer(
        _cfg(**over, weights_from=weights_from, pretrain_pth=port_path),
        "cpu", params=init)
    _assert_dicts_equal(convert.flatten_tree(pt.params_tree()),
                        convert.flatten_tree(jax.device_get(jt.params)))
    if route == "own checkpoint":
        assert pt.pretrained_keys == ([], [])


def test_cli_trains_a_step_from_a_vit_checkpoint(monkeypatch, tmp_path):
    """``-pretrain_pth vit.pth -weights_from imagenet -device cpu``: the
    flags reach the trainer, which imports before its steps (the imported
    values equal the file's before the first step) and trains."""
    pytest.importorskip("cv2")
    vit = _save(_vit_sd(), tmp_path / "vit.pth")
    monkeypatch.setattr(ptrainer, "build_model", lambda c: TimeSformer(
        num_frames=c.num_frames, img_size=c.img_size, embed_dims=E,
        num_heads=4, num_transformer_layers=2, drop_path_rate=0.0))
    seen = {}
    real_import = ptrainer.VideoTransformerTrainer.import_pretrained

    def spy(self, path):
        keys = real_import(self, path)
        seen["pos_embed"] = self.model.pos_embed.detach().clone()
        return keys

    monkeypatch.setattr(ptrainer.VideoTransformerTrainer,
                        "import_pretrained", spy)
    argv = ["-epoch", "1", "-batch_size", "4", "-num_workers", "1",
            "-num_class", "4", "-num_frames", "4", "-frame_interval", "4",
            "-img_size", "32", "-objective", "supervised", "-lr", "0.01",
            "-warmup_epochs", "1", "-root_dir", str(tmp_path),
            "-train_data_path", f"{DEMO}/demo_train_list.txt",
            "-classmap_path", f"{DEMO}/demo_classmap.json",
            "-log_interval", "1", "-device", "cpu", "-use_fp16", "False",
            "-pretrain_pth", vit, "-weights_from", "imagenet"]
    trainer = cli.single_run(argv)
    assert trainer.global_step == 3
    missing, unexpected = trainer.pretrained_keys
    assert "time_embed" in missing
    assert unexpected == ["head.weight", "head.bias"]
    np.testing.assert_array_equal(seen["pos_embed"].numpy(),
                                  _vit_sd()["pos_embed"])
    assert (trainer.configs.pretrain_pth, trainer.configs.weights_from) == \
        (vit, "imagenet")
