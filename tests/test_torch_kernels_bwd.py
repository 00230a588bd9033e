"""The backward of the port's fused kernels against the JAX package's: the
MHSA here, the FFN in tests/test_torch_kernels_bwd_ffn.py with these helpers.

Each plain backward (the CPU branch of ``fused_prenorm_mhsa`` /
``fused_prenorm_ffn``, an autograd.Function) against ``jax.grad`` of the
JAX kernel run through Pallas in interpret mode (its custom VJP with the
Pallas backward kernel) and against ``jax.grad`` of the kernel's pure-jnp
twin (``_reference_jnp``), from the same numpy inputs and the same output
gradient; every gradient is compared (x, LayerNorm scale and bias, every
weight and bias). tests/test_torch_cuda.py holds the CUDA backward kernels
against the same plain versions on a card.

Tolerances: fp32 rtol 5e-4, atol 5e-5 (those of tests/test_fused_mhsa.py:
only the summation order differs); bf16 1e-2 · max|ref| of each gradient
(about two bf16 ulps of its scale: the rounding points of the kernels agree,
the accumulation order does not, and autodiff of the jnp twin rounds at its
own points). d_wqkv in bf16: the port multiplies dqkv by xn rounded to
bf16 (as its kernel reads it), where the JAX package keeps xn in fp32, so
d_wqkv is held to DW_QKV_BF16_REL = 6e-3 of max|ref| (the rounding of xn,
2^-9 relative, partly cancelling over the rows: 3.1e-3 to 4.2e-3 in these
cases); the other gradients at the same rounding points agree to the bit
or to 1.5e-3."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from videotransformer_tpu.kernels import fused_mhsa_pallas
from videotransformer_tpu_torch.kernels import fused_ffn, fused_mhsa

BF16_REL = 1e-2
DW_QKV_BF16_REL = 6e-3
WEIGHTS = (3, 5)  # positions of the (in, out) JAX weights among the args
DW_QKV = 3  # position of w_qkv among the args


def _mhsa_args(B, N, D, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, N, D) * 0.5, rng.randn(D) * 0.1 + 1,
            rng.randn(D) * 0.1, rng.randn(D, 3 * D) * 0.08,
            rng.randn(3 * D) * 0.05, rng.randn(D, D) * 0.08,
            rng.randn(D) * 0.05]


def _jax_grads(fn, args, g, dtype):
    jargs = [jnp.asarray(a, dtype) for a in args]
    jg = jnp.asarray(g, jnp.float32)
    loss = lambda *a: (fn(*a).astype(jnp.float32) * jg).sum()
    return jax.jit(jax.grad(loss, argnums=tuple(range(len(args)))))(*jargs)


def _port_grads(fn, args, g, dtype):
    """Gradients of sum(fn(args) · g) through the port's autograd.Function,
    weights in the JAX (in, out) layout for the comparison."""
    targs = [torch.tensor(a.T if i in WEIGHTS else a).to(dtype).contiguous()
             .requires_grad_() for i, a in enumerate(args)]
    out = fn(*targs)
    loss = (out.float() * torch.from_numpy(g).float()).sum()
    grads = torch.autograd.grad(loss, targs)
    return [(t.t() if i in WEIGHTS else t).float().numpy()
            for i, t in enumerate(grads)]


def _assert_grads_close(got, want, dtype, rel=None):
    """``rel`` maps an argument's position to a bf16 tolerance of its own."""
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(jnp.asarray(b, jnp.float32))
        assert a.shape == b.shape, i
        assert np.isfinite(a).all(), i
        if dtype == "float32":
            np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-5,
                                       err_msg=f"grad {i}")
        else:
            err = np.abs(a - b).max() / np.abs(b).max()
            assert err <= (rel or {}).get(i, BF16_REL), (i, err)


MHSA_CASES = [
    # (B, N, heads, block_diag, add_residual)
    pytest.param(2, 65, 4, 0, True, id="dense-N65-res"),
    pytest.param(1, 197, 4, 0, False, id="dense-N197"),
    pytest.param(2, 64, 4, 8, False, id="blockdiag8-N64"),
    pytest.param(1, 128, 4, 8, True, id="blockdiag8-N128-res"),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,N,H,block_diag,res", MHSA_CASES)
def test_mhsa_plain_backward_matches_jax(B, N, H, block_diag, res, dtype):
    D = 64
    args = _mhsa_args(B, N, D, seed=N + block_diag + res)
    g = np.random.RandomState(7).randn(B, N, D).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    scale = (D // H) ** -0.5
    cfg = (H, scale, 1e-5, res, block_diag)
    got = _port_grads(lambda *a: fused_mhsa.fused_prenorm_mhsa(*a, *cfg),
                      args, g, getattr(torch, dtype))
    twin = _jax_grads(lambda *a: fused_mhsa_pallas._reference_jnp(
        *a, num_heads=H, scale=scale, ln_eps=1e-5, add_residual=res,
        block_diag=block_diag), args, g, jdt)
    _assert_grads_close(got, twin, dtype)
    with pltpu.force_tpu_interpret_mode():
        pallas = _jax_grads(lambda *a: fused_mhsa_pallas.fused_prenorm_mhsa(
            *a, *cfg), args, g, jdt)
    _assert_grads_close(got, pallas, dtype, {DW_QKV: DW_QKV_BF16_REL})


def _autograd_of_plain(fn, plain, args):
    """Gradients through the autograd.Function (plain backward) and through
    torch's autograd of the plain forward, fp32, from one output gradient."""
    targs = [torch.tensor(a, dtype=torch.float32).requires_grad_()
             for a in args]
    out = fn(*targs)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    return (torch.autograd.grad((out * g).sum(), targs),
            torch.autograd.grad((plain(*targs) * g).sum(), targs))


@pytest.mark.parametrize("block_diag,res", [(0, True), (8, False)])
def test_mhsa_plain_backward_is_autograd_of_plain_forward(block_diag, res):
    args = [a.T if i in WEIGHTS else a
            for i, a in enumerate(_mhsa_args(2, 64, 64, seed=3))]
    cfg = (4, 0.25, 1e-5, res, block_diag)
    got, want = _autograd_of_plain(
        lambda *a: fused_mhsa.fused_prenorm_mhsa(*a, *cfg),
        lambda *a: fused_mhsa.fused_prenorm_mhsa_reference(*a, *cfg), args)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def test_cpu_backward_counts_no_launch():
    counts = (fused_mhsa.LAUNCHES, fused_mhsa.BWD_LAUNCHES,
              fused_ffn.LAUNCHES, fused_ffn.BWD_LAUNCHES)
    x = torch.randn(2, 16, 64, requires_grad=True)
    w = [torch.ones(64), torch.zeros(64), torch.randn(192, 64) * 0.1,
         torch.zeros(192), torch.randn(64, 64) * 0.1, torch.zeros(64)]
    y = fused_mhsa.fused_prenorm_mhsa(x, *w, 4, 0.25)
    y = fused_ffn.fused_prenorm_ffn(y, w[0], w[1], torch.randn(128, 64) * 0.1,
                                    torch.zeros(128),
                                    torch.randn(64, 128) * 0.1, w[1])
    y.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert (fused_mhsa.LAUNCHES, fused_mhsa.BWD_LAUNCHES, fused_ffn.LAUNCHES,
            fused_ffn.BWD_LAUNCHES) == counts
