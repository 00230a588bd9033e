"""The port's MViT trunk without the cls token and with block dropout,
against the JAX package's ``create_multiscale_vision_transformers``
(mvit.py:593-641), on the CPU.

The tiny trunk of tests/test_torch_mvit.py (4 frames at 32², patch dim 96,
two blocks: 96 -> 192 with the ``proj`` residual, then 192 -> 192, one
q-pool stage). Every JAX parameter is perturbed from a numpy seed and
carried across by the port's converter, which maps a tree without
``cls_token`` and ``pos_embed_class`` both ways, bit for bit. The JAX
modules run on their XLA path, the port's on the kernels' plain versions.

- Eval mode: fp32 features within 1e-4 · max|ref| (summation order only,
  as tests/test_torch_mvit.py holds them), for each of no cls token, the
  cls token with dropout and neither.
- Train mode with dropout (the port draws its own uniforms, so the bits
  are not JAX's; what is held is the rule): each element kept at the rate
  1 - p, within 1% over 2·10⁵ elements, and scaled by exactly 1 / (1 - p);
  the draws follow the generator; the block with dropout never calls the
  fused FFN (B2), the one without calls it once, as JAX's
  ``use_fused_mlp`` says (mvit.py:370-375).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videotransformer_tpu import config as vt_config
from videotransformer_tpu.models import mvit as jmvit
from videotransformer_tpu_torch.kernels import fused_ffn
from videotransformer_tpu_torch.models import convert, mvit

TRUNK = dict(spatial_size=32, temporal_size=4, depth=2,
             embed_dim_mul=((1, 2.0),), atten_head_mul=((1, 2.0),),
             pool_q_stride_size=((1, 1, 2, 2),),
             pool_kv_stride_adaptive=(1, 2, 2), pool_kvq_kernel=(3, 3, 3))
TOKENS = (2, 2 * 8 * 8, 96)  # (B, T·H·W, patch dim) at 4x32², stride 2x4x4


@pytest.fixture(autouse=True)
def xla_attention():
    vt_config.set_attention_backend("xla")
    yield
    vt_config.set_attention_backend("auto")


def _rel(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _trunks(cls_embed_on, dropout):
    """The JAX trunk, its perturbed params, the port's trunk with them and
    the tokens."""
    kw = dict(TRUNK, cls_embed_on=cls_embed_on, dropout_rate_block=dropout)
    jm, _ = jmvit.create_multiscale_vision_transformers(**kw)
    x = np.random.RandomState(0).randn(*TOKENS).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    rng = np.random.RandomState(1)
    params = jax.tree.map(lambda a: np.asarray(a) + rng.randn(*a.shape)
                          .astype(np.float32) * 0.05, params)
    pm, dim = mvit.create_multiscale_vision_transformers(**kw)
    sd = convert.maskfeat_flat_to_state_dict(convert.flatten_tree(params))
    pm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                       strict=True)
    return jm, params, pm, x


@pytest.mark.parametrize("cls_embed_on,dropout", [
    (False, 0.0), (True, 0.3), (False, 0.3)])
def test_trunk_matches_jax_in_eval_mode(cls_embed_on, dropout):
    jm, params, pm, x = _trunks(cls_embed_on, dropout)
    want = jm.apply({"params": params}, jnp.asarray(x), deterministic=True)
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x))
    assert got.shape == want.shape == (2, cls_embed_on + 2 * 4 * 4, 192)
    assert _rel(got, want) <= 1e-4


def test_converter_maps_a_trunk_without_cls_both_ways():
    """The tree has no cls parameters; the port's names are the JAX
    package's maskfeat_flax_to_torch_state_dict's, and the state dict goes
    back to the same flat tree, bit for bit."""
    _, params, pm, _ = _trunks(False, 0.0)
    flat = convert.flatten_tree(params)
    assert not [k for k in flat if "cls_token" in k or "pos_embed_class" in k]
    got = pm.state_dict()
    want = {k: np.asarray(v) for k, v in
            convert.maskfeat_flat_to_state_dict(flat).items()}
    assert sorted(got) == sorted(want)
    assert "cls_positional_encoding.cls_token" not in got
    back = convert.maskfeat_state_dict_to_flat(got)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


def test_block_takes_dropout_and_no_cls():
    """MultiScaleBlock builds either variant, and runs without a cls row."""
    blk = mvit.MultiScaleBlock(64, 64, 2, dropout_rate=0.2,
                               has_cls_embed=False, kernel_kv=(3, 3, 3),
                               stride_kv=(1, 2, 2))
    blk.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(2, 2 * 4 * 4, 64, generator=torch.Generator()
                    .manual_seed(1))
    (x_cls, out), thw = blk.eval()(x, None, (2, 4, 4))
    assert x_cls is None and out.shape == x.shape and thw == (2, 4, 4)


def test_dropout_keeps_at_the_rate_and_scales():
    p = 0.3
    x = torch.ones(2, 1000, 100)
    y = mvit._dropout(x, p, True, torch.Generator().manual_seed(2), None)
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - p)) <= 0.01
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / (1 - p)))
    again = mvit._dropout(x, p, True, torch.Generator().manual_seed(2), None)
    other = mvit._dropout(x, p, True, torch.Generator().manual_seed(3), None)
    assert torch.equal(y, again) and not torch.equal(y, other)
    assert mvit._dropout(x, p, False, None, None) is x


@pytest.mark.parametrize("dropout,b2_calls", [(0.0, 1), (0.25, 0)])
def test_dropout_block_runs_the_plain_mlp(monkeypatch, dropout, b2_calls):
    """A dim == dim_out block calls B2 once a forward without dropout and
    never with it; in train mode its output follows the generator."""
    calls = []
    real = fused_ffn.fused_prenorm_ffn
    monkeypatch.setattr(fused_ffn, "fused_prenorm_ffn",
                        lambda *a: calls.append(1) or real(*a))
    blk = mvit.MultiScaleBlock(64, 64, 2, dropout_rate=dropout,
                               kernel_kv=(3, 3, 3), stride_kv=(1, 2, 2))
    blk.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(2, 2 * 4 * 4, 64, generator=torch.Generator()
                    .manual_seed(1))
    x_cls = torch.randn(2, 1, 64, generator=torch.Generator().manual_seed(2))
    run = lambda seed: blk.train()(x, x_cls, (2, 4, 4), torch.Generator()
                                   .manual_seed(seed))[0]
    a, b, c = run(5), run(5), run(6)
    assert len(calls) == 3 * b2_calls
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert torch.equal(a[1], c[1]) == (dropout == 0.0)
    (e_cls, e), _ = blk.eval()(x, x_cls, (2, 4, 4))
    assert torch.equal(e, a[1]) == (dropout == 0.0)
