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


def _mhsa_args(B, N, D, seed, Da=None):
    """x and the weights in the JAX (in, out) layout, attention width Da
    (D by default; a tensor-parallel shard's heads when smaller)."""
    Da = Da or D
    rng = np.random.RandomState(seed)
    return [rng.randn(B, N, D) * 0.5, rng.randn(D) * 0.1 + 1,
            rng.randn(D) * 0.1, rng.randn(D, 3 * Da) * 0.08,
            rng.randn(3 * Da) * 0.05, rng.randn(Da, D) * 0.08,
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
    # L > 256: the lengths the card's long attention variant takes
    pytest.param(1, 264, 4, 0, True, id="long-N264-res"),
    pytest.param(1, 320, 4, 0, False, id="long-N320"),
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


RECOMPUTE_CASES = [
    # (B, N, heads, block_diag, add_residual, Da)
    pytest.param(2, 65, 4, 0, True, 64, id="dense-N65-res"),
    pytest.param(1, 197, 4, 0, False, 64, id="dense-N197"),
    pytest.param(2, 64, 4, 8, False, 64, id="blockdiag8-N64"),
    pytest.param(1, 128, 4, 8, True, 64, id="blockdiag8-N128-res"),
    pytest.param(1, 264, 4, 0, True, 64, id="long-N264-res"),
    pytest.param(1, 264, 4, 0, False, 64, id="long-N264"),
    pytest.param(2, 65, 2, 0, False, 32, id="dense-N65-Da32"),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,N,H,block_diag,res,Da", RECOMPUTE_CASES)
def test_mhsa_recompute_qkv_backward_matches_jax(B, N, H, block_diag, res,
                                                 Da, dtype):
    """B3's recompute mode: the port's forward with RECOMPUTE_QKV keeps no
    qkv, and its plain backward rebuilds it (qkv=None); against jax.grad
    through the Pallas kernel in interpret mode with the JAX package's
    RECOMPUTE_QKV on (its recompute_qkv=True backward), at B3's bounds.
    The port's gradients equal its saved mode's to the bit, and at Da = D
    the inputs are those of the saved mode's case above, so the two tests
    read the same comparison in both modes. (At other inputs, seed + 64,
    the long case with the residual put d_wqkv at 6.25e-3 of max|ref| in
    bf16, above DW_QKV_BF16_REL: the saved mode's xn rounding, which the
    recompute mode shares bit for bit.)"""
    D = 64
    args = _mhsa_args(B, N, D, seed=N + block_diag + res + (Da != D), Da=Da)
    g = np.random.RandomState(7).randn(B, N, D).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    cfg = (H, (Da // H) ** -0.5, 1e-5, res, block_diag)
    port = lambda *a: fused_mhsa.fused_prenorm_mhsa(*a, *cfg)
    saved = _port_grads(port, args, g, getattr(torch, dtype))
    assert fused_mhsa.RECOMPUTE_QKV is False
    try:
        fused_mhsa.RECOMPUTE_QKV = True
        got = _port_grads(port, args, g, getattr(torch, dtype))
    finally:
        fused_mhsa.RECOMPUTE_QKV = False
    for a, b in zip(got, saved):
        np.testing.assert_array_equal(a, b)
    assert fused_mhsa_pallas.RECOMPUTE_QKV is False
    try:
        fused_mhsa_pallas.RECOMPUTE_QKV = True
        with pltpu.force_tpu_interpret_mode():
            pallas = _jax_grads(
                lambda *a: fused_mhsa_pallas.fused_prenorm_mhsa(*a, *cfg),
                args, g, jdt)
    finally:
        fused_mhsa_pallas.RECOMPUTE_QKV = False
    _assert_grads_close(got, pallas, dtype, {DW_QKV: DW_QKV_BF16_REL})


def test_recompute_mode_saves_no_qkv():
    """With RECOMPUTE_QKV on, the autograd graph holds x, attn and the
    weights but no (rows, 3·Da) qkv; off, it holds qkv."""
    args = [torch.tensor(a.T if i in WEIGHTS else a, dtype=torch.float32)
            .requires_grad_() for i, a in enumerate(_mhsa_args(2, 16, 64, 0))]
    widths = {}
    for mode in (False, True):
        fused_mhsa.RECOMPUTE_QKV = mode
        try:
            shapes = []
            with torch.autograd.graph.saved_tensors_hooks(
                    lambda t: shapes.append(tuple(t.shape)) or t,
                    lambda t: t):
                y = fused_mhsa.fused_prenorm_mhsa(*args, 4, 0.25)
        finally:
            fused_mhsa.RECOMPUTE_QKV = False
        y.sum().backward()
        widths[mode] = {s[-1] for s in shapes if len(s) == 2}
    assert 3 * 64 in widths[False] and 64 in widths[False]
    assert 3 * 64 not in widths[True] and 64 in widths[True]


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
