"""The port's ViViT against the JAX package's, on the CPU, for the three
attention types: ``fact_encoder`` (a spatial stack over each effective
frame, then a temporal stack over the frames' pooled tokens),
``joint_space_time`` and ``divided_space_time``.

A tiny ViViT (D 64, 4 heads, 2 spatial and 2 temporal layers, 4 frames of
32², tube 2: 2 effective frames of 4 patches) with every parameter
perturbed from a numpy seed, carried across by the port's converter. The
JAX model runs its XLA path; the port the kernels' plain versions.
Tolerances as tests/test_torch_timesformer.py: fp32 features within 1e-4 ·
max|ref| (summation order only), bf16 within 5e-2 · max|ref| (bf16 rounds
at other points in flax's modules and the port, compounded over the
blocks).

Also: the converter's names and values against ``flax_to_torch_state_dict``
with each attention type (the fact_encoder's stacks are
``transformer_layers.0`` and ``.1``) and back, the Conv3d tubelet's weight
layout, and the fact_encoder's ``x[:b, 0]`` quirk at b = 2."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videotransformer_tpu.models.convert import flax_to_torch_state_dict
from videotransformer_tpu.models.vivit import ViViT as JViViT
from videotransformer_tpu.serving.export import flatten_params
from videotransformer_tpu_torch.models import ViViT
from videotransformer_tpu_torch.models.convert import (
    jax_flat_to_state_dict, state_dict_to_jax_flat)

TYPES = ("fact_encoder", "joint_space_time", "divided_space_time")
TINY = dict(num_frames=4, img_size=32, patch_size=16, embed_dims=64,
            num_heads=4, num_transformer_layers=2,
            num_time_transformer_layers=2)


def _port(kind, params):
    model = ViViT(**TINY, attention_type=kind)
    model.load_state_dict(
        {k: torch.from_numpy(v)
         for k, v in jax_flat_to_state_dict(flatten_params(params)).items()},
        strict=True)
    return model.eval()


@pytest.fixture(scope="module", params=TYPES)
def vivit_case(request):
    kind = request.param
    jmodel = JViViT(**TINY, attention_type=kind, drop_path_rate=0.0)
    clip = np.random.RandomState(1).randn(2, 4, 3, 32, 32).astype(np.float32)
    params = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(clip))["params"])
    rng = np.random.RandomState(2)
    params = jax.tree.map(
        lambda a: np.asarray(a) + rng.randn(*a.shape).astype(np.float32)
        * 0.05, params)
    return kind, params, clip


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vivit_matches_jax(vivit_case, dtype):
    kind, params, clip = vivit_case
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jmodel = JViViT(**TINY, attention_type=kind, drop_path_rate=0.0,
                    dtype=jdt)
    want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x))(
        params, jnp.asarray(clip, jdt))
    want = np.asarray(want.astype(jnp.float32))
    tdt = getattr(torch, dtype)
    with torch.no_grad():
        got = _port(kind, params).to(tdt)(torch.from_numpy(clip).to(tdt))
    got = got.float().numpy()
    assert got.shape == want.shape == (2, 64) and np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= (1e-4 if dtype == "float32" else 5e-2), err


def test_mean_pooled_readout_matches_jax(vivit_case):
    """return_cls_token=False: the mean of the non-cls rows after the final
    LayerNorm (vivit.py:218-220)."""
    kind, params, clip = vivit_case
    jmodel = JViViT(**TINY, attention_type=kind, drop_path_rate=0.0,
                    return_cls_token=False)
    want = np.asarray(jax.jit(lambda p, x: jmodel.apply({"params": p}, x))(
        params, jnp.asarray(clip)))
    port = _port(kind, params)
    port.return_cls_token = False
    with torch.no_grad():
        got = port(torch.from_numpy(clip)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_converter_matches_flax_to_torch_state_dict(vivit_case):
    """Names and values of each type against the JAX package's export, and
    back to the flax tree unchanged."""
    kind, params, _ = vivit_case
    want = flax_to_torch_state_dict(params, attention_type=kind)
    flat = flatten_params(params)
    got = jax_flat_to_state_dict(flat)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back = state_dict_to_jax_flat(got)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], np.asarray(flat[k]),
                                      err_msg=k)
    stacks = {k.split(".")[1] for k in got
              if k.startswith("transformer_layers.")}
    assert stacks == ({"0", "1"} if kind == "fact_encoder" else {"layers"})


def test_fact_encoder_reproduces_the_first_rows_quirk(vivit_case):
    """fact_encoder feeds the temporal stack ``x[:b, 0]`` of the (b·T', 1 +
    p, d) spatial output: at b = 2 (T' = 2) clip 1's cls row is clip 0's
    second frame's. So clip 1's features change when only clip 0 changes,
    and differ from clip 1's alone; the other types keep clips apart."""
    kind, params, clip = vivit_case
    port = _port(kind, params)
    other = clip.copy()
    other[0] = np.random.RandomState(3).randn(*clip.shape[1:])
    with torch.no_grad():
        both = port(torch.from_numpy(clip))
        changed = port(torch.from_numpy(other))
        alone = port(torch.from_numpy(clip[1:]))
    moved = (changed[1] - both[1]).abs().max().item()
    apart = (alone[0] - both[1]).abs().max().item()
    if kind == "fact_encoder":
        assert moved > 1e-3 and apart > 1e-3, (moved, apart)
    else:
        assert moved <= 1e-5 and apart <= 1e-5, (moved, apart)


def test_vivit_base_has_the_reference_names():
    """ViViT-B/16 at 16 frames, as the JAX trainer builds it."""
    with torch.device("meta"):
        joint = ViViT(16, attention_type="joint_space_time")
        fact = ViViT(16)
    sd = joint.state_dict()
    assert sd["patch_embed.projection.weight"].shape == (768, 3, 2, 16, 16)
    assert sd["pos_embed"].shape == (1, 197, 768)
    assert sd["time_embed"].shape == (1, 8, 768)
    assert "transformer_layers.layers.11.attentions.0.attn.qkv.weight" in sd
    sd = fact.state_dict()
    assert sd["time_embed"].shape == (1, 9, 768)
    assert "transformer_layers.0.layers.11.ffns.0.layers.1.weight" in sd
    assert "transformer_layers.1.layers.3.attentions.0.norm.weight" in sd
    assert "transformer_layers.1.layers.4.attentions.0.norm.weight" not in sd


def test_unknown_attention_type_raises():
    with pytest.raises(ValueError, match="Unsupported Attention Type"):
        ViViT(**TINY, attention_type="space_only")
