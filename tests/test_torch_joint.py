"""Joint space-time attention of the port against the JAX package's, on the
CPU: ``JointAttention`` on each of its branches, and TimeSformer's
``joint_space_time`` and ``space_only`` types.

``JointAttention`` (D 64) at N = 9 (4 heads), N = 197 (4 heads), N =
2100 at head dim 32 (2 heads) and N = 2100 at head dim 64 (1 head): up to
2048 tokens the port makes one fused prenorm-MHSA call (B1, B3 on the
card), as the JAX package does; above it the unfused form with flash
attention (B5, B6) at head dim 32, as the JAX package does, and the fused
call at head dim 64, where B1's and B3's long variant run B5's and B6's
kernels in place (the JAX package goes unfused there: it is held against
JAX's unfused module). The JAX package sends N < 64 to a VPU path that is
not ported; the port sends N = 9 (the ViViT fact_encoder's temporal stack)
to B1/B3 as well, and on the card B1 takes its dense variant there and B3
its CUDA-core one. On the CPU every branch runs the kernels' plain
versions and the JAX modules their XLA path; both start from the same
numpy parameters, carried across by the port's converter.

Tolerances: fp32 outputs within 1e-4 · max|ref| and gradients rtol 5e-4,
atol 5e-5 (summation order only, as tests/test_torch_kernels_bwd.py);
TimeSformer features as tests/test_torch_timesformer.py holds them, fp32
1e-4 · max|ref| and bf16 5e-2 · max|ref| (bf16 rounds at other points in
flax's modules and the port, compounded over two blocks)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videotransformer_tpu.models.convert import flax_to_torch_state_dict
from videotransformer_tpu.models.timesformer import TimeSformer as JTimeSformer
from videotransformer_tpu.ops.blocks import JointAttention as JJoint
from videotransformer_tpu.serving.export import flatten_params
from videotransformer_tpu_torch.kernels import flash_attention, fused_mhsa
from videotransformer_tpu_torch.models.convert import jax_flat_to_state_dict
from videotransformer_tpu_torch.models.timesformer import TimeSformer
from videotransformer_tpu_torch.ops import blocks
from videotransformer_tpu_torch.ops.blocks import JointAttention

D = 64


def _perturbed(params, seed, std=0.05):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + rng.randn(*a.shape).astype(np.float32) * std,
        jax.device_get(params))


def _state_dict(params):
    return {k: torch.from_numpy(v)
            for k, v in jax_flat_to_state_dict(flatten_params(params)).items()}


def _rel_err(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module",
                params=[(9, 4), (197, 4), (2100, 2), (2100, 1)],
                ids=["N9", "N197", "N2100-hd32", "N2100-hd64"])
def joint_case(request):
    """(JAX module, its params, the port's module, x) at (N, heads)."""
    N, H = request.param
    jmod = JJoint(D, H)
    x = np.random.RandomState(N).randn(1, N, D).astype(np.float32)
    params = _perturbed(jmod.init(jax.random.PRNGKey(N), jnp.asarray(x))
                        ["params"], seed=N)
    port = JointAttention(D, H)
    port.load_state_dict(_state_dict(params), strict=True)
    return jmod, params, port.eval(), x


def test_joint_attention_branches_match_jax(joint_case, monkeypatch):
    """The forward against JAX JointAttention, through the branch its
    length and head dim take: the fused call up to 2048 tokens and at head
    dim 64, flash attention above 2048 tokens at other head dims."""
    jmod, params, port, x = joint_case
    calls = {"fused": 0, "flash": 0}

    def counted(name, fn):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run

    monkeypatch.setattr(fused_mhsa, "fused_prenorm_mhsa", counted(
        "fused", fused_mhsa.fused_prenorm_mhsa))
    monkeypatch.setattr(flash_attention, "flash_attention", counted(
        "flash", flash_attention.flash_attention))
    want = np.asarray(jax.jit(jmod.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    long = x.shape[1] > blocks.FUSED_MHSA_MAX_N and D // jmod.num_heads != 64
    assert calls == {"fused": int(not long), "flash": int(long)}
    assert got.shape == want.shape
    assert _rel_err(got, want) <= 1e-4


def _gradients_match_jax(B, N, H, seed):
    """The gradients of sum(out · g) with respect to x and every parameter,
    the port's backward against jax.grad of the JAX module."""
    jmod = JJoint(D, H)
    rng = np.random.RandomState(seed)
    x = rng.randn(B, N, D).astype(np.float32)
    g = rng.randn(B, N, D).astype(np.float32)
    params = _perturbed(jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x))
                        ["params"], seed=seed)

    def loss(p, xx):
        return (jmod.apply({"params": p}, xx) * g).sum()

    jgp, jgx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    port = JointAttention(D, H)
    port.load_state_dict(_state_dict(params), strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    (port(xt) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=5e-4,
                               atol=5e-5)
    want = jax_flat_to_state_dict(flatten_params(jax.device_get(jgp)))
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=5e-4,
                                   atol=5e-5, err_msg=name)


def test_joint_attention_gradients_match_jax():
    """At N = 197 (the fused branch): the port's plain backward (B3's)
    against jax.grad of the JAX module."""
    _gradients_match_jax(2, 197, 4, 5)


def test_long_joint_attention_gradients_match_jax(monkeypatch):
    """At N = 2100 and head dim 64 (the fused branch above 2048 tokens, B3's
    long variant on the card): the port's plain backward (B3's) against
    jax.grad of the JAX module's unfused form."""
    calls = []
    real = fused_mhsa.fused_prenorm_mhsa
    monkeypatch.setattr(fused_mhsa, "fused_prenorm_mhsa",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    monkeypatch.setattr(flash_attention, "flash_attention", None)
    _gradients_match_jax(1, 2100, 1, 6)
    assert calls == [(1, 2100, D)]


TINY = dict(num_frames=4, img_size=32, patch_size=16, embed_dims=D,
            num_heads=4, num_transformer_layers=2)


@pytest.fixture(scope="module", params=["joint_space_time", "space_only"])
def timesformer_case(request):
    kind = request.param
    jmodel = JTimeSformer(**TINY, attention_type=kind, drop_path_rate=0.0)
    clip = np.random.RandomState(1).randn(2, 4, 3, 32, 32).astype(np.float32)
    params = _perturbed(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(clip))["params"], seed=0)
    return kind, params, clip


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_timesformer_types_match_jax(timesformer_case, dtype):
    kind, params, clip = timesformer_case
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jmodel = JTimeSformer(**TINY, attention_type=kind, drop_path_rate=0.0,
                          dtype=jdt)
    want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x))(
        params, jnp.asarray(clip, jdt))
    want = np.asarray(want.astype(jnp.float32))
    port = TimeSformer(**TINY, attention_type=kind)
    port.load_state_dict(_state_dict(params), strict=True)
    tdt = getattr(torch, dtype)
    with torch.no_grad():
        got = port.to(tdt).eval()(torch.from_numpy(clip).to(tdt))
    got = got.float().numpy()
    assert got.shape == want.shape == (2, D) and np.isfinite(got).all()
    assert _rel_err(got, want) <= (1e-4 if dtype == "float32" else 5e-2)


def test_timesformer_types_have_the_reference_names(timesformer_case):
    """The converter's names and values are flax_to_torch_state_dict's;
    space_only has no time_embed."""
    kind, params, _ = timesformer_case
    want = flax_to_torch_state_dict(params, attention_type=kind)
    got = jax_flat_to_state_dict(flatten_params(params))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert ("time_embed" in got) == (kind != "space_only")
    assert "transformer_layers.layers.1.attentions.0.attn.qkv.weight" in got
