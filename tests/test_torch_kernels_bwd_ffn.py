"""The backward of the port's fused prenorm FFN against the JAX package's.

The plain backward (the CPU branch of ``fused_prenorm_ffn``, an
autograd.Function) against ``jax.grad`` of the JAX kernel run through Pallas
in interpret mode and of its pure-jnp twin, from the same numpy inputs and
output gradient, every gradient compared, at the tolerances and with the
helpers of tests/test_torch_kernels_bwd.py (the MHSA half); also the plain
backward against torch autograd of the plain forward, and when the forward
keeps h_pre."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from test_torch_kernels_bwd import (
    WEIGHTS, _assert_grads_close, _autograd_of_plain, _jax_grads,
    _port_grads)
from videotransformer_tpu.kernels import fused_ffn_pallas
from videotransformer_tpu_torch.kernels import fused_ffn


def _ffn_args(M, D, hidden, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(M, D) * 0.5, rng.randn(D) * 0.1 + 1,
            rng.randn(D) * 0.1, rng.randn(D, hidden) * 0.1,
            rng.randn(hidden) * 0.05, rng.randn(hidden, D) * 0.05,
            rng.randn(D) * 0.05]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [150, 280])
def test_ffn_plain_backward_matches_jax(M, dtype):
    D, hidden = 64, 256
    args = _ffn_args(M, D, hidden, seed=M)
    g = np.random.RandomState(8).randn(M, D).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    got = _port_grads(fused_ffn.fused_prenorm_ffn, args, g,
                      getattr(torch, dtype))
    twin = _jax_grads(lambda *a: fused_ffn_pallas._reference_jnp(*a, 1e-5),
                      args, g, jdt)
    _assert_grads_close(got, twin, dtype)
    with pltpu.force_tpu_interpret_mode():
        pallas = _jax_grads(lambda *a: fused_ffn_pallas.fused_prenorm_ffn(
            *a, 1e-5), args, g, jdt)
    _assert_grads_close(got, pallas, dtype)


def test_ffn_plain_backward_is_autograd_of_plain_forward():
    args = [a.T if i in WEIGHTS else a
            for i, a in enumerate(_ffn_args(96, 64, 256, seed=4))]
    got, want = _autograd_of_plain(fused_ffn.fused_prenorm_ffn,
                                   fused_ffn.fused_prenorm_ffn_reference, args)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def test_h_pre_is_saved_only_when_a_gradient_is_wanted(monkeypatch):
    """Serving (no_grad or inference_mode, even with parameters that require
    grad) asks the forward for no h_pre; training does."""
    asked = []
    real = fused_ffn._FusedPrenormFFN.forward
    monkeypatch.setattr(fused_ffn._FusedPrenormFFN, "forward", staticmethod(
        lambda ctx, *a: asked.append(a[-1]) or real(ctx, *a)))
    x = torch.randn(4, 64)
    w = [torch.nn.Parameter(t) for t in (
        torch.ones(64), torch.zeros(64), torch.randn(128, 64),
        torch.zeros(128), torch.randn(64, 128), torch.zeros(64))]
    with torch.no_grad():
        assert fused_ffn.fused_prenorm_ffn(x, *w).grad_fn is None
    with torch.inference_mode():
        fused_ffn.fused_prenorm_ffn(x, *w)
    out = fused_ffn.fused_prenorm_ffn(x, *w)
    assert out.grad_fn is not None
    assert asked == [False, False, True]
