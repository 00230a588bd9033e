"""The port's checkpoint import against the JAX package's, on the CPU.

The same numpy state dicts go through both packages' surgery, loaders and
merges: a synthetic image ViT (the original repo's naming, layer 0 in the
current names and layer 1 in the older ``norms.{0,1}`` / ``in_proj_`` /
``out_proj`` ones, plus an image ``head``), a synthetic MAE checkpoint, and
``.pth`` files the JAX package's ``save_torch_checkpoint`` writes (Kinetics
and MaskFeat). Tiny models: TimeSformer and ViViT at D 32, 4 heads, 2
layers, 32²; the depth-4 MaskFeat of tests/test_torch_mim_training.py.

Exact: the surgery's dicts, the loaders' dicts, every merged leaf (through
``state_dict_to_jax_flat``), and the merge's missing and unexpected names
once the JAX package's flax paths are mapped to the port's names (the JAX
merge names an absent subtree once; the port lists its keys). Forwards
after an import: fp32 within 1e-4 · max|ref|, as
tests/test_torch_timesformer.py and test_torch_vivit.py hold them. The
``.pth`` exchange both ways, the trainer's routes and the CLI are in
tests/test_torch_checkpoint_training.py."""

import argparse
import fractions
import functools
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videotransformer_tpu.models import convert as jconvert
from videotransformer_tpu.models.maskfeat import MaskFeat as JMaskFeat
from videotransformer_tpu.models.timesformer import TimeSformer as JTimeSformer
from videotransformer_tpu.models.vivit import ViViT as JViViT
from videotransformer_tpu_torch.models import convert
from videotransformer_tpu_torch.models.maskfeat import MaskFeat
from videotransformer_tpu_torch.models.timesformer import TimeSformer
from videotransformer_tpu_torch.models.vivit import ViViT

E = 32
TS = dict(num_frames=2, img_size=32, patch_size=16, embed_dims=E,
          num_heads=4, num_transformer_layers=2)
VV = dict(num_frames=4, img_size=32, patch_size=16, embed_dims=E,
          num_heads=4, num_transformer_layers=2,
          num_time_transformer_layers=2)
DEPTH4 = dict(depth=4, embed_dim_mul=((1, 2.0), (3, 2.0)),
              atten_head_mul=((1, 2.0), (3, 2.0)),
              pool_q_stride_size=((1, 1, 2, 2), (3, 1, 2, 2)),
              feature_dim=2 * 2 * 2 * 3 * 9)
MF = dict(img_size=32, num_frames=4)


def _r(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _vit_sd(patches=4, layers=2, seed=3):
    """An image ViT in the original repo's naming: layer 0 in the current
    names, layer 1 in the older ones the surgery renames; an image head."""
    rng = np.random.RandomState(seed)
    sd = {"cls_token": _r(rng, 1, 1, E),
          "pos_embed": _r(rng, 1, patches + 1, E),
          "patch_embed.projection.weight": _r(rng, E, 3, 16, 16),
          "patch_embed.projection.bias": _r(rng, E)}
    for i in range(layers):
        b = f"transformer_layers.layers.{i}"
        if i == 0:
            names = {"n0": f"{b}.attentions.0.norm", "n1": f"{b}.ffns.0.norm",
                     "qkv_w": f"{b}.attentions.0.attn.qkv.weight",
                     "qkv_b": f"{b}.attentions.0.attn.qkv.bias",
                     "proj": f"{b}.attentions.0.attn.proj"}
        else:
            names = {"n0": f"{b}.norms.0", "n1": f"{b}.norms.1",
                     "qkv_w": f"{b}.attentions.0.attn.in_proj_weight",
                     "qkv_b": f"{b}.attentions.0.attn.in_proj_bias",
                     "proj": f"{b}.attentions.0.attn.out_proj"}
        sd.update({
            f"{names['n0']}.weight": _r(rng, E), f"{names['n0']}.bias":
            _r(rng, E), names["qkv_w"]: _r(rng, 3 * E, E),
            names["qkv_b"]: _r(rng, 3 * E),
            f"{names['proj']}.weight": _r(rng, E, E),
            f"{names['proj']}.bias": _r(rng, E),
            f"{names['n1']}.weight": _r(rng, E), f"{names['n1']}.bias":
            _r(rng, E),
            f"{b}.ffns.0.layers.0.0.weight": _r(rng, 4 * E, E),
            f"{b}.ffns.0.layers.0.0.bias": _r(rng, 4 * E),
            f"{b}.ffns.0.layers.1.weight": _r(rng, E, 4 * E),
            f"{b}.ffns.0.layers.1.bias": _r(rng, E)})
    sd.update({"norm.weight": _r(rng, E), "norm.bias": _r(rng, E),
               "head.weight": _r(rng, 10, E), "head.bias": _r(rng, 10)})
    return sd


def _mae_sd(layers=2, seed=7):
    """An MAE checkpoint's names: encoder blocks with q/v biases, the
    decoder (dropped by the surgery)."""
    rng = np.random.RandomState(seed)
    sd = {"encoder.patch_embed.proj.weight": _r(rng, E, 3, 16, 16),
          "encoder.patch_embed.proj.bias": _r(rng, E),
          "encoder.norm.weight": _r(rng, E), "encoder.norm.bias": _r(rng, E),
          "decoder.blocks.0.attn.qkv.weight": _r(rng, 3 * E, E),
          "decoder.norm.weight": _r(rng, E)}
    for i in range(layers):
        b = f"encoder.blocks.{i}"
        sd.update({f"{b}.norm1.weight": _r(rng, E), f"{b}.norm1.bias":
                   _r(rng, E), f"{b}.attn.qkv.weight": _r(rng, 3 * E, E),
                   f"{b}.attn.q_bias": _r(rng, E),
                   f"{b}.attn.v_bias": _r(rng, E),
                   f"{b}.attn.proj.weight": _r(rng, E, E),
                   f"{b}.attn.proj.bias": _r(rng, E),
                   f"{b}.norm2.weight": _r(rng, E), f"{b}.norm2.bias":
                   _r(rng, E), f"{b}.mlp.fc1.weight": _r(rng, 4 * E, E),
                   f"{b}.mlp.fc1.bias": _r(rng, 4 * E),
                   f"{b}.mlp.fc2.weight": _r(rng, E, 4 * E),
                   f"{b}.mlp.fc2.bias": _r(rng, E)})
    return sd


def _assert_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _save(sd, path):
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return str(path)


# ------------------------------------------------------------------ surgery

@pytest.mark.parametrize("conv_type,extend", [
    ("Conv2d", "temporal_avg"), ("Conv3d", "temporal_avg"),
    ("Conv3d", "center_frame")])
@pytest.mark.parametrize("copy_strategy", ["repeat", "set_zero"])
@pytest.mark.parametrize("attention_type", [
    "divided_space_time", "fact_encoder", "joint_space_time"])
def test_vit_surgery_matches_jax(attention_type, copy_strategy, conv_type,
                                 extend):
    sd = _vit_sd()
    args = (conv_type, attention_type, copy_strategy, extend, 2, 1)
    _assert_dicts_equal(convert.surgery_from_vit_pretrain(sd, *args),
                        jconvert.surgery_from_vit_pretrain(sd, *args))


@pytest.mark.parametrize("conv_type", ["Conv2d", "Conv3d"])
@pytest.mark.parametrize("attention_type", [
    "divided_space_time", "fact_encoder"])
def test_mae_surgery_matches_jax(attention_type, conv_type):
    sd = _mae_sd()
    args = (conv_type, attention_type, "repeat")
    got = convert.surgery_from_mae_pretrain(sd, *args)
    _assert_dicts_equal(got, jconvert.surgery_from_mae_pretrain(sd, *args))
    qkv = got[("transformer_layers.0.layers.0" if attention_type
               == "fact_encoder" else "transformer_layers.layers.0")
              + ".attentions.0.attn.qkv.bias"]
    np.testing.assert_array_equal(qkv[E:2 * E], 0)
    assert not any("decoder" in k for k in got)


def test_replace_state_dict_matches_jax():
    rng = np.random.RandomState(0)
    sd = {"model.cls_token": _r(rng, 1, 1, E),
          "model.transformer_layers.layers.0.attentions.0.attn.in_proj_weight":
          _r(rng, 3 * E, E),
          "model.transformer_layers.layers.0.attentions.0.attn.out_proj.bias":
          _r(rng, E),
          "cls_head.cls_head.weight": _r(rng, 10, E),
          "cls_head.cls_head.bias": _r(rng, 10)}
    got = convert.replace_state_dict(sd)
    _assert_dicts_equal(got, jconvert.replace_state_dict(sd))
    assert "cls_head.weight" in got and \
        "transformer_layers.layers.0.attentions.0.attn.qkv.weight" in got


def test_maskfeat_key_renames_are_the_identity_in_the_port():
    """The JAX surgery maps pytorchvideo's names to its flax modules'; the
    port's MaskFeat carries pytorchvideo's names (its converter's
    ``_MASKFEAT_NAMES`` undo the JAX renames), so an import renames
    nothing."""
    model = MaskFeat(**MF, **DEPTH4)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    renamed = jconvert.surgery_maskfeat_keys(sd)
    assert renamed != sd  # the JAX surgery does rename
    assert list(convert._rename(renamed, convert._MASKFEAT_NAMES)) == list(sd)


# ------------------------------------------------------------------ loading

def _lightning_payloads(sd):
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    prefixed = {f"model.{k}": t for k, t in tensors.items()}
    return {
        "bare": tensors,
        "state_dict": {"state_dict": prefixed, "epoch": 3},
        "lightning": {"state_dict": prefixed, "epoch": 3, "global_step": 40,
                      "pytorch-lightning_version": "1.5.0",
                      "hyper_parameters": argparse.Namespace(
                          lr=5e-3, arch="timesformer"),
                      "optimizer_states": [{"state": {}, "param_groups": [
                          {"lr": 5e-3, "params": [0, 1]}]}]},
        "model": {"model": tensors, "epoch": 400,
                  "args": argparse.Namespace(model="vit_base")}}


@pytest.mark.parametrize("kind", ["bare", "state_dict", "lightning", "model"])
def test_load_torch_state_dict_matches_jax(tmp_path, kind):
    """A bare dict, Lightning's ``{"state_dict": ...}`` with and without
    its pickled ``Namespace`` of hyper-parameters, and MAE's
    ``{"model": ...}``: the same arrays as the JAX loader."""
    path = str(tmp_path / f"{kind}.pth")
    torch.save(_lightning_payloads(_vit_sd())[kind], path)
    _assert_dicts_equal(convert.load_torch_state_dict(path),
                        jconvert.load_torch_state_dict(path))


def test_checkpoint_with_other_objects_is_refused(tmp_path):
    """``weights_only`` loading: an object other than tensors, containers,
    plain scalars and ``argparse.Namespace`` raises instead of running its
    pickle (the JAX loader would unpickle it)."""
    path = str(tmp_path / "odd.pth")
    torch.save({"state_dict": {"w": torch.ones(2)},
                "extra": fractions.Fraction(1, 3)}, path)
    assert "w" in jconvert.load_torch_state_dict(path)
    with pytest.raises(pickle.UnpicklingError, match="Fraction"):
        convert.load_torch_state_dict(path)
    with pytest.raises(FileNotFoundError):
        convert.read_checkpoint(str(tmp_path / "absent.pth"))


# ------------------------------------------------- merge and imported leaves

def _jax_model(arch, attention_type):
    if arch == "timesformer":
        return JTimeSformer(**TS, attention_type=attention_type,
                            drop_path_rate=0.0), (1, 2, 3, 32, 32)
    if arch == "vivit":
        return JViViT(**VV, attention_type=attention_type,
                      drop_path_rate=0.0), (1, 4, 3, 32, 32)
    return JMaskFeat(**MF, **DEPTH4), None


def _port_model(arch, attention_type):
    if arch == "timesformer":
        return TimeSformer(**TS, attention_type=attention_type,
                           drop_path_rate=0.0)
    if arch == "vivit":
        return ViViT(**VV, attention_type=attention_type, drop_path_rate=0.0)
    return MaskFeat(**MF, **DEPTH4)


@functools.lru_cache(maxsize=None)
def _jax_init(arch, attention_type):
    """The JAX model's init, jitted once per model (key -> params)."""
    model, shape = _jax_model(arch, attention_type)
    if shape is None:  # MaskFeat: the mim trainer's init inputs
        return jax.jit(lambda k: model.init(
            k, jnp.zeros((1, 4, 3, 32, 32)), target_x=None,
            mask=jnp.zeros((1, 2, 2, 2), jnp.int32),
            cube_marker=jnp.zeros((1, 8, 2), jnp.int32),
            cube_count=jnp.zeros((1,), jnp.int32))["params"])
    return jax.jit(lambda k: model.init(k, jnp.zeros(shape))["params"])


def _jax_params(arch, attention_type, seed=0):
    """The JAX model's initialisation, every leaf perturbed (numpy)."""
    params = _jax_init(arch, attention_type)(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed + 1)
    return jax.tree.map(lambda a: np.asarray(a) + _r(rng, *a.shape) * 0.02,
                        jax.device_get(params))


def _port_from(arch, attention_type, params):
    model = _port_model(arch, attention_type)
    model_sd, _ = convert.trainer_tree_to_state_dicts({"model": params})
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in model_sd.items()}, strict=True)
    return model


def _port_flat(model):
    return convert.flatten_tree(
        convert.state_dicts_to_trainer_tree(model.state_dict())["model"])


def _names(flat):
    """{JAX flat path: the port's state-dict name} over one flat tree (the
    FFN's Sequential index needs the whole tree)."""
    to_sd = (convert.maskfeat_flat_to_state_dict
             if any(k.startswith("mvit/") for k in flat)
             else convert.jax_flat_to_state_dict)
    return dict(zip(flat, to_sd(flat)))


def _jax_lists_as_port_names(params, imported, missing, unexpected):
    """merge_params's missing and unexpected paths as the port's names:
    a shape-mismatch entry keeps its suffix; an absent subtree stands for
    every imported key under it."""
    own = _names(convert.flatten_tree(params))
    src = _names(convert.flatten_tree(imported))
    got_missing = {own[p] for p in missing}
    got_unexpected = set()
    for p in unexpected:
        if " (shape " in p:
            path, rest = p.split(" (shape ", 1)
            got_unexpected.add(f"{own[path]} (shape {rest}")
        else:
            got_unexpected |= {n for k, n in src.items()
                               if k == p or k.startswith(p + "/")}
    return got_missing, got_unexpected


def _jax_import(route, params, path, attention_type, conv_type):
    """The JAX package's init_* of ``route``, in its steps, with the
    merge's missing and unexpected lists."""
    sd = jconvert.load_torch_state_dict(path)
    if route == "vit":
        sd = jconvert.surgery_from_vit_pretrain(sd, conv_type,
                                                attention_type, "repeat")
    elif route == "mae":
        sd = jconvert.surgery_from_mae_pretrain(sd, conv_type,
                                                attention_type, "repeat")
    elif route == "kinetics":
        sd = jconvert.replace_state_dict(sd)
    else:
        sd = jconvert.surgery_maskfeat_keys(jconvert.replace_state_dict(sd))
    imported = jconvert.torch_to_flax_params(sd, attention_type)
    merged, missing, unexpected = jconvert.merge_params(params, imported)
    return jax.device_get(merged), imported, missing, unexpected


def _port_import(route, model, path, attention_type, conv_type):
    if route == "vit":
        return convert.init_from_vit_pretrain(model, path, conv_type,
                                              attention_type, "repeat")
    if route == "mae":
        return convert.init_from_mae_pretrain(model, path, conv_type,
                                              attention_type, "repeat")
    if route == "kinetics":
        return convert.init_from_kinetics_pretrain(model, path)
    return convert.init_maskfeat_from_kinetics_pretrain(model, path)


def _route_file(route, arch, attention_type, tmp_path):
    """The file each route reads: the ViT and MAE dicts (a ViT of 9
    patches and a ``time_embed`` of 3 frames for the shape mismatches),
    else a ``.pth`` the JAX package's save_torch_checkpoint writes from
    another perturbed tree (with a head, but for MaskFeat)."""
    if route == "vit":
        sd = _vit_sd(patches=9)
        sd["time_embed"] = _r(np.random.RandomState(4), 1, 3, E)
        return _save(sd, tmp_path / "vit.pth")
    if route == "mae":
        return _save(_mae_sd(), tmp_path / "mae.pth")
    path = str(tmp_path / f"{route}.pth")
    head = None if arch == "mvit" else {"cls_head": {
        "kernel": _r(np.random.RandomState(8), E, 10),
        "bias": _r(np.random.RandomState(9), 10)}}
    jconvert.save_torch_checkpoint(
        _jax_params(arch, attention_type, seed=11), path, attention_type,
        cls_head=head, arch="mvit" if arch == "mvit" else "timesformer")
    return path


ROUTES = [("vit", "timesformer", "divided_space_time", "Conv2d"),
          ("vit", "timesformer", "joint_space_time", "Conv2d"),
          ("vit", "vivit", "fact_encoder", "Conv3d"),
          ("mae", "timesformer", "divided_space_time", "Conv2d"),
          ("mae", "vivit", "fact_encoder", "Conv3d"),
          ("kinetics", "timesformer", "divided_space_time", None),
          ("kinetics", "vivit", "fact_encoder", None),
          ("maskfeat", "mvit", None, None)]


@pytest.mark.parametrize("route,arch,attention_type,conv_type", ROUTES)
def test_import_matches_jax_merge(tmp_path, route, arch, attention_type,
                                  conv_type):
    """Each import from the same file into the same initial parameters:
    every leaf after it equal to the JAX merged tree's, and the missing
    and unexpected names equal to merge_params's (shape mismatches
    included); the MaskFeat import of a JAX MaskFeat .pth has neither."""
    path = _route_file(route, arch, attention_type, tmp_path)
    params = _jax_params(arch, attention_type)
    merged, imported, j_missing, j_unexpected = _jax_import(
        route, params, path, attention_type, conv_type)
    model = _port_from(arch, attention_type, params)
    missing, unexpected = _port_import(route, model, path, attention_type,
                                       conv_type)
    _assert_dicts_equal(_port_flat(model), convert.flatten_tree(merged))
    want_missing, want_unexpected = _jax_lists_as_port_names(
        params, imported, j_missing, j_unexpected)
    assert set(missing) == want_missing
    assert set(unexpected) == want_unexpected
    if route == "vit":
        assert any("(shape (1, 10, 32) vs (1, 5, 32))" in u
                   for u in unexpected)
    if route == "maskfeat":
        assert missing == [] and unexpected == []


@pytest.mark.parametrize("arch,attention_type,shape", [
    ("timesformer", "divided_space_time", (2, 2, 3, 32, 32)),
    ("vivit", "fact_encoder", (2, 4, 3, 32, 32))])
def test_forward_after_vit_import_matches_jax(tmp_path, arch,
                                              attention_type, shape):
    path = _route_file("vit", arch, attention_type, tmp_path)
    params = _jax_params(arch, attention_type)
    conv = "Conv3d" if arch == "vivit" else "Conv2d"
    merged = _jax_import("vit", params, path, attention_type, conv)[0]
    model = _port_from(arch, attention_type, params)
    _port_import("vit", model, path, attention_type, conv)
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    want = np.asarray(_jax_model(arch, attention_type)[0].apply(
        {"params": merged}, jnp.asarray(x)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
