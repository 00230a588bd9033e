"""The port's MViT and MaskFeat against the JAX package's, on the CPU.

Tiny configurations (tests/test_mvit.py:69-73): 4 frames at 32², patch
dim 96, two blocks (96 -> 192 with the ``proj`` residual, then 192 -> 192
through the fused-FFN kernel's plain version), one q-pool stage, head dim 96
in both blocks. Every JAX parameter is perturbed from a numpy seed (the
LayerNorm scales away from 1, the biases away from 0) and carried across by
the port's converter; the JAX modules run on their XLA path
(``set_attention_backend("xla")``), the port's on the kernels' plain
versions.

Tolerances: fp32 features, loss and outputs within 1e-4 · max|ref|, every
gradient within 2e-4 · max|ref| of that gradient (summation order only: the
flash attention's plain version normalises p before the PV product as the
einsum path's softmax does). bf16 features within 5e-2 · max|ref| (bf16
rounds at other points in flax's modules and the port, over two blocks).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videotransformer_tpu import config as vt_config
from videotransformer_tpu.models import mvit as jmvit
from videotransformer_tpu.models.convert import (
    maskfeat_flax_to_torch_state_dict)
from videotransformer_tpu.models.maskfeat import MaskFeat as JMaskFeat
from videotransformer_tpu_torch.models import convert, mvit
from videotransformer_tpu_torch.models.maskfeat import MaskFeat

TINY = dict(img_size=32, num_frames=4, depth=2,
            embed_dim_mul=((1, 2.0),), atten_head_mul=((1, 2.0),),
            pool_q_stride_size=((1, 1, 2, 2),),
            pool_kv_stride_adaptive=(1, 2, 2), pool_kvq_kernel=(3, 3, 3),
            feature_dim=2 * 27)
TRAINER_MVIT = dict(
    depth=16, num_heads=1, patch_embed_dim=96,
    embed_dim_mul=[[1, 2.0], [3, 2.0], [14, 2.0]],
    atten_head_mul=[[1, 2.0], [3, 2.0], [14, 2.0]],
    pool_q_stride_size=[[1, 1, 2, 2], [3, 1, 2, 2]],
    pool_kv_stride_adaptive=[1, 8, 8], pool_kvq_kernel=[3, 3, 3])


@pytest.fixture(autouse=True)
def xla_attention():
    vt_config.set_attention_backend("xla")
    yield
    vt_config.set_attention_backend("auto")


def _perturb(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + rng.randn(*a.shape).astype(np.float32)
        * 0.05, params)


def _rel(got, want):
    got = np.asarray(got.detach().float() if hasattr(got, "detach") else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _load(module, flat):
    sd = convert.maskfeat_flat_to_state_dict(flat)
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                           strict=True)
    return module


def _mim_inputs(seed=0, B=2):
    rng = np.random.RandomState(seed)
    x = rng.rand(B, 4, 3, 32, 32).astype(np.float32)
    mask = (rng.rand(B, 2, 4, 4) > 0.4).astype(np.int32)
    marker = np.zeros((B, 3, 2), np.int32)
    marker[:, 0] = [0, 1]
    marker[0, 1] = [1, 1]
    count = np.array([2, 1], np.int32)[:B]
    target = rng.rand(B, 4, 4, 4, 27).astype(np.float32)
    return x, mask, marker, count, target


@pytest.fixture(scope="module")
def tiny_pair():
    """The JAX tiny MaskFeat's perturbed params and the port's model."""
    vt_config.set_attention_backend("xla")
    x, mask, marker, count, _ = _mim_inputs()
    jm = JMaskFeat(**TINY)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x), None,
                              jnp.asarray(mask), jnp.asarray(marker),
                              jnp.asarray(count))["params"]
    params = _perturb(params, 1)
    model = _load(MaskFeat(**TINY), convert.flatten_tree(params))
    return jm, params, model


def test_round_width_and_schedule_match_jax():
    for args in [(96, 2.0, 1, 2), (1, 2.0), (96, 1.0), (192, 2.0, 1, 4),
                 (100, 1.5, 1, 8)]:
        assert mvit.round_width(*args) == jmvit.round_width(*args)
    got, dim = mvit.build_mvit_block_configs(**TRAINER_MVIT)
    want, jdim = jmvit.build_mvit_block_configs(**TRAINER_MVIT)
    assert got == want and dim == jdim == 768
    # the trainer's schedule: q pools at blocks 1 and 3, KV strides
    # 8 -> 4 -> 2, widths 96/192/384/768
    assert [c["dim"] for c in got][:4] == [96, 192, 192, 384]
    assert [c["num_heads"] for c in got][13:] == [4, 8, 8]
    assert [i for i, c in enumerate(got) if c["stride_q"]] == [1, 3]
    assert [c["stride_kv"] for c in got][:4] == [(1, 8, 8), (1, 4, 4),
                                                 (1, 4, 4), (1, 2, 2)]


@pytest.mark.parametrize("stride_q", [(), (1, 2, 2)])
def test_multiscale_attention_matches_jax(stride_q):
    B, T, H, W, dim, heads = 2, 2, 4, 4, 64, 2
    kq = (3, 3, 3) if stride_q else ()
    cfg = dict(kernel_q=kq, kernel_kv=(3, 3, 3), stride_q=stride_q,
               stride_kv=(1, 2, 2))
    x = np.random.RandomState(0).randn(B, 1 + T * H * W, dim).astype(
        np.float32)
    jm = jmvit.MultiScaleAttention(dim=dim, num_heads=heads, **cfg)
    params = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                              (T, H, W))["params"], 2)
    want, want_thw = jm.apply({"params": params}, jnp.asarray(x), (T, H, W))
    pm = _load(mvit.MultiScaleAttention(dim, heads, **cfg),
               convert.flatten_tree(params))
    xt = torch.from_numpy(x)
    (out_cls, out), thw = pm(xt[:, 1:], xt[:, :1], (T, H, W))
    assert thw == tuple(want_thw)
    assert _rel(torch.cat([out_cls, out], 1), want) <= 1e-4


@pytest.mark.parametrize("dim,dim_out,stride_q", [
    (96, 192, ()),            # the plain MLP and the proj residual
    (96, 96, (1, 2, 2)),      # the fused FFN, q pooling and the skip pool
])
def test_multiscale_block_matches_jax(dim, dim_out, stride_q):
    B, T, H, W = 2, 2, 4, 4
    cfg = dict(dim=dim, dim_out=dim_out, num_heads=2,
               kernel_q=(3, 3, 3) if stride_q else (), kernel_kv=(3, 3, 3),
               stride_q=stride_q, stride_kv=(1, 2, 2))
    x = np.random.RandomState(1).randn(B, 1 + T * H * W, dim).astype(
        np.float32)
    jm = jmvit.MultiScaleBlock(**cfg)
    params = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                              (T, H, W))["params"], 3)
    want, want_thw = jm.apply({"params": params}, jnp.asarray(x), (T, H, W))
    pm = _load(mvit.MultiScaleBlock(**cfg), convert.flatten_tree(params))
    xt = torch.from_numpy(x)
    (out_cls, out), thw = pm(xt[:, 1:], xt[:, :1], (T, H, W))
    assert thw == tuple(want_thw)
    assert _rel(torch.cat([out_cls, out], 1), want) <= 1e-4


@pytest.mark.parametrize("shape,kernel,stride", [
    ((2, 4, 9, 7, 5), (1, 3, 3), (1, 2, 2)),   # MViT's skip pool, ragged
    ((2, 5, 8, 8, 3), (3, 3, 3), (2, 2, 2)),
    ((1, 3, 6, 6, 4), (1, 1, 1), (1, 1, 1)),
])
def test_skip_maxpool_and_its_gradient_match_jax(shape, kernel, stride):
    """The skip path's max pool and its written-out backward against
    jax.grad through reduce_window (fp32: only the order of the adds
    differs)."""
    padding = [k // 2 for k in kernel]
    rng = np.random.RandomState(sum(shape))
    x = rng.randn(*shape).astype(np.float32)
    want = jmvit._maxpool3d(jnp.asarray(x), kernel, stride, padding)
    gy = rng.randn(*want.shape).astype(np.float32)
    want_g = jax.grad(lambda a: jnp.sum(
        jmvit._maxpool3d(a, kernel, stride, padding) * gy))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = mvit._maxpool3d(xt, kernel, stride, padding)
    got.backward(torch.from_numpy(gy))
    assert np.array_equal(got.detach().numpy(), np.asarray(want))
    assert _rel(xt.grad, want_g) <= 1e-6


def test_droppath_pair_shares_one_mask_per_sample():
    blk = mvit.MultiScaleBlock(64, 64, 2, droppath_rate=0.5,
                               kernel_kv=(3, 3, 3), stride_kv=(1, 2, 2))
    blk.train()
    h, h_cls = torch.ones(64, 5, 8), torch.ones(64, 1, 8)
    a, b = blk._droppath_pair(h, h_cls, torch.Generator().manual_seed(0))
    kept = a[:, 0, 0] != 0
    assert torch.equal(kept, b[:, 0, 0] != 0) and 0 < int(kept.sum()) < 64
    assert torch.all(a[kept] == 2.0) and torch.all(b[kept] == 2.0)
    blk.eval()
    assert blk._droppath_pair(h, h_cls, None)[0] is h


def test_maskfeat_features_loss_and_grads_match_jax(tiny_pair):
    jm, params, model = tiny_pair
    x, mask, marker, count, target = _mim_inputs()
    jx = [jnp.asarray(a) for a in (x, target, mask, marker, count)]

    def loss_fn(p):
        return jm.apply({"params": p}, *jx)[1]

    feats = jax.jit(lambda p: jm.apply({"params": p}, jx[0], jx[2],
                                       method="forward_features"))(params)
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    model.zero_grad()
    tx = [torch.from_numpy(a) for a in (x, target, mask, marker, count)]
    got_feats = model.forward_features(tx[0], tx[2])
    preds, loss = model(*tx)
    loss.backward()
    assert preds.shape == (2, 4, 4, 4, 27)
    assert _rel(got_feats, feats) <= 1e-4
    assert abs(loss.item() - float(jloss)) <= 1e-4 * abs(float(jloss))
    want = maskfeat_flax_to_torch_state_dict(jax.device_get(jgrads))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for n, g in got.items():
        if n.endswith("norm_k.bias"):
            # a shift of every key by one vector leaves each softmax row as
            # it is: the exact gradient is 0, both sides hold rounding noise
            scale = np.abs(want[n[:-4] + "weight"]).max()
            assert max(float(g.abs().max()), np.abs(want[n]).max()) \
                <= 1e-4 * scale, n
            continue
        assert _rel(g, want[n]) <= 2e-4, (n, _rel(g, want[n]))


def test_maskfeat_bf16_features_match_jax(tiny_pair):
    _, params, model = tiny_pair
    x, mask, *_ = _mim_inputs(seed=4)
    jm = JMaskFeat(**TINY, dtype=jnp.bfloat16)
    want = jax.jit(lambda p, a, m: jm.apply(
        {"params": p}, a, m, method="forward_features"))(
            params, jnp.asarray(x), jnp.asarray(mask))
    got = model.forward_features(torch.from_numpy(x).bfloat16(),
                                 torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    assert _rel(got, want.astype(jnp.float32)) <= 5e-2


def test_visualize_outputs_match_jax():
    cfg = dict(TINY, feature_dim=216)
    x, mask, marker, count, _ = _mim_inputs(seed=5)
    target = np.random.RandomState(6).rand(2, 4, 4, 4, 108).astype(np.float32)
    jm = JMaskFeat(**cfg)
    jx = [jnp.asarray(a) for a in (x, target, mask, marker, count)]
    params = _perturb(jax.jit(jm.init)(jax.random.PRNGKey(1), *jx)["params"],
                      7)
    want = jax.jit(lambda p: jm.apply({"params": p}, *jx, visualize=True))(
        params)
    model = _load(MaskFeat(**cfg), convert.flatten_tree(params))
    with torch.no_grad():
        got = model(*[torch.from_numpy(a) for a in
                      (x, target, mask, marker, count)], visualize=True)
    assert got[3].shape == (2, 4, 8, 8, 3, 9)
    for a, b in zip(got, want):
        assert _rel(a, b) <= 1e-4


def test_converter_keys_and_shapes_match_jax(tiny_pair):
    """The port's state_dict keys and shapes are exactly those of the JAX
    package's maskfeat_flax_to_torch_state_dict, and the trainer tree round
    trips bit for bit, with and without a head."""
    _, params, model = tiny_pair
    want = maskfeat_flax_to_torch_state_dict(params)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, k
    assert got["mvit.blocks.1.attn.pool_q.weight"].shape == (96, 1, 3, 3, 3)
    head = {"cls_head": {"kernel": np.ones((192, 10), np.float32),
                         "bias": np.zeros(10, np.float32)}}
    for tree in ({"model": params}, {"model": params, "cls_head": head}):
        back = convert.state_dicts_to_trainer_tree(
            *convert.trainer_tree_to_state_dicts(tree))
        a, b = convert.flatten_tree(tree), convert.flatten_tree(back)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
