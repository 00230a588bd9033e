"""The port's training parts against the JAX package's: mixup (with the
JAX draws fed in, and from a torch.Generator), DropPath (one block with the
same masks fed to both packages, the per-leading-row rule, the depth
linspace), the schedules, the top-k counts, and the per-tensor optimizer
with its no-decay groups and per-parameter clip.

tests/test_torch_training.py holds the trainer as a whole against the JAX
trainer; the tolerances are stated in each test."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_training import TINY, _jax_mixup_draws
from videotransformer_tpu.data.mixup import Mixup as JMixup
from videotransformer_tpu.ops import blocks as jblocks
from videotransformer_tpu.training import metrics as jmetrics
from videotransformer_tpu.training import schedules as jschedules
from videotransformer_tpu.training import trainer as jtrainer
from videotransformer_tpu_torch.data.mixup import Mixup
from videotransformer_tpu_torch.models import convert
from videotransformer_tpu_torch.models.timesformer import TimeSformer
from videotransformer_tpu_torch.ops import blocks
from videotransformer_tpu_torch.training import metrics, schedules
from videotransformer_tpu_torch.training.optimizer import RefOptimizer


def test_mixup_matches_jax_with_the_same_draws():
    """Both branches (mixup and cutmix) from JAX keys, the draws fed to the
    port: equal clips and soft targets."""
    jmix, pmix = JMixup(num_classes=10), Mixup(num_classes=10)
    rng = np.random.RandomState(3)
    x = rng.rand(4, 2, 3, 32, 32).astype(np.float32)
    target = np.array([0, 3, 7, 9], np.int32)
    seen = set()
    for i in range(40):
        key = jax.random.PRNGKey(i)  # a train step's key
        _, mix_key = jax.random.split(key)
        d = _jax_mixup_draws(key, 32, 32, jmix)
        if d["use_cutmix"] in seen:
            continue
        seen.add(d["use_cutmix"])
        want_x, want_y = jmix(mix_key, jnp.asarray(x), jnp.asarray(target))
        got_x, got_y = pmix.apply(torch.from_numpy(x),
                                  torch.from_numpy(target), d)
        np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                                   rtol=1e-6, atol=1e-7)
        if seen == {True, False}:
            break
    assert seen == {True, False}


def test_mixup_draws_from_a_torch_generator():
    pmix = Mixup(num_classes=10)
    draws = [pmix.sample_draws(torch.Generator().manual_seed(s), 32, 32,
                               "cpu") for s in range(200)]
    assert {d["use_cutmix"] for d in draws} == {True, False}
    assert all(d["do_mix"] for d in draws)  # prob 1.0
    lam = np.array([d["lam_mixup"] for d in draws])
    assert ((0 < lam) & (lam < 1)).all() and abs(lam.mean() - 0.5) < 0.06
    assert all(0 <= d["cy"] < 32 and 0 <= d["cx"] < 32 for d in draws)
    again = pmix.sample_draws(torch.Generator().manual_seed(5), 32, 32, "cpu")
    assert again == draws[5]


def _feed_masks(masks):
    """drop_path stand-ins for both packages that take their keep masks, in
    call order, from ``masks``."""
    it_j, it_p = iter(list(masks)), iter(list(masks))

    def jax_drop_path(x, rate, deterministic, rng):
        return x / (1.0 - rate) * jnp.asarray(next(it_j), x.dtype)

    def port_drop_path(x, rate, generator, mesh=None):
        return x / (1.0 - rate) * torch.from_numpy(next(it_p)).to(x.dtype)
    return jax_drop_path, port_drop_path


def test_drop_path_block_matches_jax_with_the_same_masks(monkeypatch):
    """One block in training mode with DropPath 0.3: temporal masks per
    (b·p) row, spatial per (b·t) row, FFN per sample, fed to both packages;
    the block's output and the gradients of its input and of every
    parameter agree (fp32, rtol 5e-4, atol 5e-5)."""
    b, t, p, d = 2, 2, 4, 64
    order = ("time_attn", "space_attn", "ffn")
    jblock = jblocks.BasicTransformerBlock(
        embed_dims=d, num_heads=4, num_frames=t, hidden_channels=4 * d,
        operator_order=order, dpr=0.3)
    rng = np.random.RandomState(4)
    x = rng.randn(b, 1 + p * t, d).astype(np.float32)
    params = jax.jit(jblock.init)(jax.random.PRNGKey(0),
                                  jnp.asarray(x))["params"]
    params = jax.tree.map(lambda a: np.asarray(a) + rng.randn(*a.shape)
                          .astype(np.float32) * 0.05, params)
    masks = [(rng.rand(n, 1, 1) < 0.6).astype(np.float32)
             for n in (b * p, b * t, b)]
    g = rng.randn(*x.shape).astype(np.float32)

    jax_dp, port_dp = _feed_masks(masks)
    monkeypatch.setattr(jblocks, "drop_path", jax_dp)

    def loss(prm, xx):
        out = jblock.apply({"params": prm}, xx, deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(1)})
        return (out * g).sum(), out
    (_, want), (jg_p, jg_x) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))

    monkeypatch.setattr(blocks, "drop_path", port_dp)
    pblock = blocks.BasicTransformerBlock(d, 4, t, 4 * d, order,
                                          drop_path_rate=0.3).train()
    sd = convert.jax_flat_to_state_dict(convert.flatten_tree(params))
    pblock.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                           strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    got = pblock(xt)
    (got * torch.from_numpy(g)).sum().backward()

    tol = dict(rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg_x), **tol)
    want_g = convert.jax_flat_to_state_dict(
        convert.flatten_tree(jax.device_get(jg_p)))
    for name, prm in pblock.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), want_g[name],
                                   err_msg=name, **tol)


def test_drop_path_masks_whole_leading_rows_at_the_keep_rate():
    """One keep/drop draw per leading-axis row, nothing across rows: each
    row comes out all 0 or all 1/keep, and the kept share of 4000 rows is
    within 5 standard deviations of the keep rate."""
    rate, rows = 0.25, 4000
    out = blocks.drop_path(torch.ones(rows, 9, 8), rate,
                           torch.Generator().manual_seed(0))
    per_row = out.reshape(rows, -1)
    kept = (per_row[:, 0] > 0)
    assert torch.equal(per_row, per_row[:, :1].expand_as(per_row))
    assert torch.allclose(per_row[kept], torch.full_like(per_row[kept],
                                                        1 / (1 - rate)))
    sd = (rate * (1 - rate) / rows) ** 0.5
    assert abs(kept.float().mean().item() - (1 - rate)) < 5 * sd
    layer = blocks.DropPath(rate)
    x = torch.randn(6, 3)
    assert layer.eval()(x) is x and blocks.DropPath(0.0).train()(x) is x


def test_drop_path_linspace_over_depth():
    model = TimeSformer(**TINY, drop_path_rate=0.1)
    rates = [[m.rate for m in layer.modules()
              if isinstance(m, blocks.DropPath)]
             for layer in model.transformer_layers.layers]
    assert rates == [[0.0] * 3, [0.1] * 3]


def test_schedules_match_jax():
    for epoch in range(30):
        for objective in ("mim", "supervised"):
            assert schedules.cosine_with_warmup_epoch(
                epoch, 5e-3, 5, 30, objective, 1e-6) == \
                jschedules.cosine_with_warmup_epoch(
                    epoch, 5e-3, 5, 30, objective, 1e-6)
        assert schedules.multistep_epoch(epoch, 0.1) == \
            jschedules.multistep_epoch(epoch, 0.1)
        assert schedules.cosine_weight_decay(epoch, 30, 0.05, 0.2) == \
            jschedules.cosine_weight_decay(epoch, 30, 0.05, 0.2)


def test_topk_counts_match_jax():
    rng = np.random.RandomState(6)
    logits = rng.randn(12, 10).astype(np.float32)
    labels = rng.randint(0, 10, 12).astype(np.int32)
    labels[-3:] = -1
    want = jmetrics.topk_correct(jnp.asarray(logits), jnp.asarray(labels))
    got = metrics.topk_correct(torch.from_numpy(logits),
                               torch.from_numpy(labels))
    assert {k: int(v) for k, v in got.items()} == \
        {k: int(v) for k, v in want.items()}
    meter = metrics.AccuracyMeter()
    meter.update(got, 9)
    assert meter.compute(1) == int(got[1]) / 9


@pytest.mark.parametrize("optim_type", ["adamw", "sgd"])
@pytest.mark.parametrize("clip_grad", [0.0, 0.1])
def test_optimizer_matches_jax_per_tensor(optim_type, clip_grad):
    """Three updates of the port's optimizer against the JAX package's
    per-tensor RefOptimizer from the same parameters and gradients, with the
    no-decay groups and the per-parameter clip: parameters and grad norms
    within fp32 rounding (rtol 1e-5, atol 1e-6, as tests/test_training.py
    holds the JAX one against torch.optim)."""
    rng = np.random.RandomState(9)
    shapes = {"fc.weight": (8, 8), "fc.bias": (8,), "norm.weight": (8,),
              "pos_embed": (1, 4, 8), "time_embed": (1, 2, 8)}
    init = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    params = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for n, v in init.items()}
    opt = RefOptimizer(params.items(), optim_type, clip_grad=clip_grad)
    jparams = {n: jnp.asarray(v) for n, v in init.items()}
    jopt = jtrainer.build_optimizer(
        SimpleNamespace(optim_type=optim_type, clip_grad=clip_grad,
                        arch="timesformer"), jparams, is_pretrain=False)
    state = jopt.init(jparams)
    for _ in range(3):
        grads = {n: rng.randn(*s).astype(np.float32)
                 for n, s in shapes.items()}
        for n, p in params.items():
            p.grad = torch.from_numpy(grads[n].copy())
        got_norm = float(opt.step(1e-2, 0.05))
        jparams, state, want_norm = jopt.update(
            {n: jnp.asarray(g) for n, g in grads.items()}, state, jparams,
            1e-2, 0.05)
        np.testing.assert_allclose(got_norm, float(want_norm), rtol=1e-5)
    for n, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[n]),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
