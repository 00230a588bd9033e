"""The port's blocks (videotransformer_tpu_torch.ops.blocks) against the JAX
package's flax blocks at fp32 on the CPU.

Each JAX block is initialised, every parameter is perturbed from a numpy
seed (so the zero-initialised ``temporal_fc`` is nonzero and the temporal
attention shows in the output), the parameters go to the port through
``videotransformer_tpu.models.convert.flax_to_torch_state_dict`` with
``strict=True``, and both blocks see the same numpy input. The JAX side runs
its plain XLA path (``set_attention_backend("xla")``). Tolerance rtol 1e-4,
atol 1e-5: fp32 on both sides, only the summation order differs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videotransformer_tpu import config as vt_config
from videotransformer_tpu.models.convert import flax_to_torch_state_dict
from videotransformer_tpu.ops import blocks as jblocks
from videotransformer_tpu_torch.ops import blocks as tblocks
from videotransformer_tpu_torch.ops import initializers as tinit

D, H, T, P = 64, 4, 4, 9  # width, heads, frames, patches per frame


@pytest.fixture(autouse=True)
def xla_backend():
    vt_config.set_attention_backend("xla")
    yield
    vt_config.set_attention_backend("auto")


def _perturbed(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + rng.randn(*a.shape).astype(np.float32) * 0.05,
        params)


def _load(module, state_dict):
    module.load_state_dict(
        {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in state_dict.items()}, strict=True)
    return module.eval()


def _check(jmod, tmod, x, seed, wrap=None):
    """Init + perturb the JAX block, load it into the port, compare."""
    params = _perturbed(jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x))
                        ["params"], seed)
    if wrap:  # convert under a parent name, then strip it
        sd = flax_to_torch_state_dict({wrap[0]: params})
        sd = {k[len(wrap[1]):]: v for k, v in sd.items()}
    else:
        sd = flax_to_torch_state_dict(params)
    _load(tmod, sd)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _tokens(seed, b=2):
    return np.random.RandomState(seed).randn(b, 1 + P * T, D).astype(np.float32)


@pytest.mark.parametrize("kind", ["temporal", "spatial"])
@pytest.mark.parametrize("use_cls_token", [False, True])
def test_divided_attention_matches_jax(kind, use_cls_token):
    jcls = {"temporal": jblocks.DividedTemporalAttention,
            "spatial": jblocks.DividedSpatialAttention}[kind]
    tcls = {"temporal": tblocks.DividedTemporalAttention,
            "spatial": tblocks.DividedSpatialAttention}[kind]
    _check(jcls(D, H, T, use_cls_token=use_cls_token),
           tcls(D, H, T, use_cls_token=use_cls_token),
           _tokens(1), seed=2)


def test_ffn_matches_jax():
    _check(jblocks.FFN(D, 4 * D), tblocks.FFN(D, 4 * D), _tokens(3), seed=4,
           wrap=("ffns_0", "ffns.0."))


@pytest.mark.parametrize("depth", [1, 2])
def test_transformer_container_matches_jax(depth):
    order = ("time_attn", "space_attn", "ffn")
    _check(jblocks.TransformerContainer(depth, D, H, T, 4 * D, order,
                                        drop_path_rate=0.0),
           tblocks.TransformerContainer(depth, D, H, T, 4 * D, order),
           _tokens(5), seed=6)


def test_basic_block_matches_jax():
    order = ("time_attn", "space_attn", "ffn")
    _check(jblocks.BasicTransformerBlock(D, H, T, 4 * D, order),
           tblocks.BasicTransformerBlock(D, H, T, 4 * D, order),
           _tokens(7), seed=8)


def test_patch_embed_matches_jax():
    x = np.random.RandomState(9).randn(2, T, 3, 32, 48).astype(np.float32)
    _check(jblocks.PatchEmbed(img_size=32, patch_size=16, embed_dims=D),
           tblocks.PatchEmbed(32, 16, 3, D), x, seed=10)


def test_classification_head_matches_jax():
    x = np.random.RandomState(11).randn(5, D).astype(np.float32)
    _check(jblocks.ClassificationHead(10, D), tblocks.ClassificationHead(10, D),
           x, seed=12)


@pytest.mark.parametrize("n,d", [(197, 768), (9, 64)])
def test_sine_cosine_table_matches_jax(n, d):
    np.testing.assert_array_equal(
        tblocks.get_sine_cosine_pos_emb(n, d).numpy(),
        np.asarray(jblocks.get_sine_cosine_pos_emb(n, d)))


def test_self_attn_block_matches_jax():
    """The joint-attention block ``(self_attn, ffn)`` over all 1 + P·T
    tokens (the fused call's branch; tests/test_torch_joint.py holds each
    of JointAttention's branches)."""
    order = ("self_attn", "ffn")
    _check(jblocks.BasicTransformerBlock(D, H, T, 4 * D, order),
           tblocks.BasicTransformerBlock(D, H, T, 4 * D, order),
           _tokens(13), seed=14)


def test_tubelet_patch_embed_matches_jax():
    """The Conv3d tubelet (tube 2): (b, t, c, h, w) -> (b·t/2, gh·gw, D),
    with the conv weight (D, c, 2, 16, 16)."""
    x = np.random.RandomState(15).randn(2, T, 3, 32, 48).astype(np.float32)
    _check(jblocks.PatchEmbed(img_size=32, patch_size=16, embed_dims=D,
                              tube_size=2, conv_type="Conv3d"),
           tblocks.PatchEmbed(32, 16, 3, D, tube_size=2, conv_type="Conv3d"),
           x, seed=16)


# ------------------------------------------------------------ initializers

def test_initializers_follow_the_generator():
    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        block = tblocks.BasicTransformerBlock(
            D, H, T, 4 * D, ("time_attn", "space_attn", "ffn"))
        block.reset_parameters(g)
        return block.state_dict()

    a, b, c = draw(0), draw(0), draw(1)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert not torch.equal(a["attentions.1.attn.qkv.weight"],
                           c["attentions.1.attn.qkv.weight"])
    # temporal_fc starts at zero (blocks.py:252-255), LayerNorms at (1, 0)
    assert not a["attentions.0.temporal_fc.weight"].any()
    assert not a["attentions.0.temporal_fc.bias"].any()
    assert torch.equal(a["ffns.0.norm.weight"], torch.ones(D))


@pytest.mark.parametrize("name", ["linear", "trunc_normal", "kaiming"])
def test_initializer_distributions(name):
    g = torch.Generator().manual_seed(3)
    if name == "linear":
        lin = torch.nn.Linear(256, 512)
        tinit.torch_linear_(lin, g)
        bound = 1 / 16
        assert lin.weight.abs().max() <= bound
        assert abs(lin.weight.std().item() - bound / 3 ** 0.5) < 2e-3
        assert lin.bias.abs().max() <= bound
    elif name == "trunc_normal":
        t = torch.empty(200, 300)
        tinit.trunc_normal_(t, g, std=0.02)
        assert abs(t.std().item() - 0.02) < 5e-4
        assert abs(t.mean().item()) < 5e-4
        t = torch.empty(20000)
        tinit.trunc_normal_(t, g, std=1.0, a=-0.5, b=0.5)
        assert t.min() >= -0.5 and t.max() <= 0.5
    else:
        w = torch.empty(256, 3, 16, 16)
        tinit.kaiming_normal_fan_in_relu_(w, g)
        assert abs(w.std().item() - (2 / 768) ** 0.5) < 2e-3
