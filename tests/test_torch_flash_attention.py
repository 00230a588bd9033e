"""The port's plain flash attention (B5's forward, B6's backward) against
the JAX package's Pallas kernel, on the CPU.

The same numpy q, k, v and output gradient go through
``videotransformer_tpu.kernels.flash_attention_pallas.flash_attention``
under ``pltpu.force_tpu_interpret_mode()`` (forward, and ``jax.vjp`` through
its custom VJP with the Pallas backward kernel) and through the port's
``flash_attention`` on CPU tensors, whose autograd.Function runs the plain
versions. Nq and Nkv ragged and unequal, head dims 32, 64 (joint
space-time attention's; (197, 197) is above one 128-key tile of the card's
hd-64 design) and 96.

Tolerances, as max|port - jax| / max|jax| of the output and of each
gradient:

- fp32: 2e-5. The algorithms agree; the port takes delta = rowsum(do · o)
  where the Pallas kernel takes rowsum(dp · p), equal up to fp32 rounding,
  and sums in another order.
- bf16 inputs, the port computing in fp32 (no rounding of its own) against
  the Pallas kernel's bf16 results: 5e-3, the ROADMAP's bar for the B
  kernels, for the output and every gradient.
- bf16 throughout: the output 5e-3 (the forward rounds at the same points);
  the gradients 1e-2, two bf16 ulps of their scale. The backward rounds p
  and ds to bf16 before the products that take them (dv = pᵀ do, dq = ds k,
  dk = dsᵀ q: tensor-core operands on the card) where the Pallas kernel
  keeps them in fp32, and one rounding flip of a result in the top binade is
  already 2^-7 = 7.8e-3 of max|jax|: measured 2.8e-3 to 7.3e-3 on these
  cases.

The CUDA kernels are held against these plain versions on a card in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from videotransformer_tpu.kernels.flash_attention_pallas import (
    flash_attention as pallas_flash_attention)
from videotransformer_tpu_torch.kernels import flash_attention as fa

# (output, gradients) per dtype of the port's computation
TOL = {"float32": (2e-5, 2e-5), "bf16 inputs, fp32": (5e-3, 5e-3),
       "bfloat16": (5e-3, 1e-2)}


def _inputs(Nq, Nkv, hd, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32)
            for s in ((2, 2, Nq, hd), (2, 2, Nkv, hd), (2, 2, Nkv, hd),
                      (2, 2, Nq, hd))]


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _port(q, k, v, do, scale, dtype):
    """(o, dq, dk, dv) of the port's Function on CPU tensors of ``dtype``."""
    qt, kt, vt = (torch.tensor(t).to(dtype).requires_grad_()
                  for t in (q, k, v))
    o = fa.flash_attention(qt, kt, vt, scale)
    o.backward(torch.tensor(do).to(dtype))
    return o.detach(), qt.grad, kt.grad, vt.grad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [32, 64, 96])
@pytest.mark.parametrize("Nq,Nkv", [(64, 64), (200, 50), (130, 260),
                                    (197, 197)])
def test_plain_flash_attention_matches_pallas(Nq, Nkv, hd, dtype):
    q, k, v, do = _inputs(Nq, Nkv, hd, Nq + Nkv + hd)
    scale = hd ** -0.5
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(
            lambda a, b, c: pallas_flash_attention(a, b, c, scale),
            *[jnp.asarray(t, jdt) for t in (q, k, v)])
        want = [np.asarray(t.astype(jnp.float32))
                for t in (out, *vjp(jnp.asarray(do, jdt)))]
    runs = {"float32": (_port(q, k, v, do, scale, torch.float32), torch.float32)}
    if dtype == "bfloat16":
        as_bf16 = [torch.tensor(t).bfloat16().float().numpy()
                   for t in (q, k, v, do)]
        runs = {"bf16 inputs, fp32": (_port(*as_bf16, scale, torch.float32),
                                      torch.float32),
                "bfloat16": (_port(q, k, v, do, scale, torch.bfloat16),
                             torch.bfloat16)}
    for run, (got, tdt) in runs.items():
        for i, (name, a, b) in enumerate(zip(("o", "dq", "dk", "dv"), got,
                                             want)):
            assert a.dtype == tdt and tuple(a.shape) == b.shape, name
            err = _rel(a.float(), b)
            assert err <= TOL[run][min(i, 1)], (run, name, err)


def test_autograd_function_matches_torch_autograd_of_plain_forward():
    """On the CPU the Function's backward (the plain B6) equals torch's own
    autograd through the plain forward's fp32 math."""
    q, k, v, do = (torch.tensor(t, dtype=torch.float64).float()
                   for t in _inputs(70, 45, 32, 0))
    scale = 0.3
    args = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention(*args, scale).backward(do)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    s = torch.matmul(ref[0], ref[1].transpose(-1, -2)) * scale
    (torch.softmax(s, -1) @ ref[2]).backward(do)
    for a, b in zip(args, ref):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-6)


def test_forward_returns_the_row_logsumexp():
    q, k, v, _ = (torch.from_numpy(t) for t in _inputs(33, 17, 32, 1))
    o, lse = fa._forward_reference(q, k, v, 0.2)
    s = torch.matmul(q, k.transpose(-1, -2)) * 0.2
    torch.testing.assert_close(lse, torch.logsumexp(s, -1))
    torch.testing.assert_close(o, torch.softmax(s, -1) @ v)
