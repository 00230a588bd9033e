"""The attention-weights path of the port against the JAX package's, on the
CPU: ``get_last_selfattention`` of TimeSformer (divided, joint and
space-only attention) and of ViViT (fact_encoder, joint and divided), the
softmax weights of the last block's last attention, from the same numpy
parameters carried across by the port's converter.

Both packages run the blocks before it as usual (the port's kernels' plain
versions, the JAX modules' XLA path) and that attention on the plain
``Attention`` with ``need_weights``. Tolerances: fp32 within 1e-5 of the
JAX weights (each in [0, 1]; summation order only); bf16 within 5e-2 ·
max|ref|, the bound tests/test_torch_joint.py holds the features to (bf16
rounds at other points in flax's modules and the port, compounded over two
blocks). Also: the model's training mode is restored, and a model sharded
over tensor-parallel ranks refuses (a rank holds a part of the heads)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videotransformer_tpu.models.timesformer import TimeSformer as JTimeSformer
from videotransformer_tpu.models.vivit import ViViT as JViViT
from videotransformer_tpu.serving.export import flatten_params
from videotransformer_tpu_torch.models.convert import jax_flat_to_state_dict
from videotransformer_tpu_torch.models.timesformer import TimeSformer
from videotransformer_tpu_torch.models.vivit import ViViT
from videotransformer_tpu_torch.ops.blocks import Attention

B, FRAMES, HEADS = 2, 4, 4
TINY = dict(num_frames=FRAMES, img_size=32, patch_size=16, embed_dims=64,
            num_heads=HEADS, num_transformer_layers=2)
# (JAX class, port class, extra kwargs, the weights' shape)
CASES = {
    "timesformer-divided": (JTimeSformer, TimeSformer,
                            dict(attention_type="divided_space_time"),
                            (B * FRAMES, HEADS, 5, 5)),
    "timesformer-joint": (JTimeSformer, TimeSformer,
                          dict(attention_type="joint_space_time"),
                          (B, HEADS, 17, 17)),
    "timesformer-space_only": (JTimeSformer, TimeSformer,
                               dict(attention_type="space_only"),
                               (B * FRAMES, HEADS, 5, 5)),
    "vivit-fact_encoder": (JViViT, ViViT,
                           dict(attention_type="fact_encoder",
                                num_time_transformer_layers=2),
                           (B, HEADS, 3, 3)),
    "vivit-joint": (JViViT, ViViT, dict(attention_type="joint_space_time"),
                    (B, HEADS, 9, 9)),
    "vivit-divided": (JViViT, ViViT,
                      dict(attention_type="divided_space_time"),
                      (B * FRAMES // 2, HEADS, 5, 5)),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    jcls, pcls, extra, shape = CASES[request.param]
    clip = np.random.RandomState(1).randn(B, FRAMES, 3, 32, 32).astype(
        np.float32)
    jmodel = jcls(**TINY, **extra, drop_path_rate=0.0)
    params = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(clip))["params"])
    rng = np.random.RandomState(2)
    params = jax.tree.map(
        lambda a: np.asarray(a) + rng.randn(*a.shape).astype(np.float32)
        * 0.05, params)
    port = pcls(**TINY, **extra)
    port.load_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in
         jax_flat_to_state_dict(flatten_params(params)).items()},
        strict=True)
    return jcls, extra, shape, params, port, clip


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_last_selfattention_matches_jax(case, dtype):
    jcls, extra, shape, params, port, clip = case
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jmodel = jcls(**TINY, **extra, drop_path_rate=0.0, dtype=jdt)
    want = jax.jit(lambda p, x: jmodel.apply(
        {"params": p}, x, method=jmodel.get_last_selfattention))(
            params, jnp.asarray(clip, jdt))
    want = np.asarray(want.astype(jnp.float32))
    tdt = getattr(torch, dtype)
    model = port.to(tdt).train()
    with torch.no_grad():
        got = model.get_last_selfattention(torch.from_numpy(clip).to(tdt))
    assert model.training  # restored
    assert got.dtype == torch.float32
    got = got.numpy()
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    err = np.abs(got - want).max()
    if dtype == "float32":
        assert err <= 1e-5, err
    else:
        assert err <= 5e-2 * np.abs(want).max(), err


def test_sharded_attention_refuses_weights():
    attn = Attention(64, 4, tp=2)
    with pytest.raises(NotImplementedError, match="tp=2"):
        attn(torch.zeros(1, 5, 64))
