"""The port's fused kernels (videotransformer_tpu_torch.kernels) against the
JAX package's: each plain PyTorch version against the Pallas kernel's
pure-jnp twin (``_reference_jnp``) and against the Pallas kernel itself in
interpret mode, from the same numpy inputs. On the CPU the wrappers run the
plain versions; tests/test_torch_cuda.py holds the CUDA kernels against them
on a card.

Tolerances: fp32 as tests/test_fused_mhsa.py (rtol 2e-4, atol 2e-5: only
the summation order differs); bf16 1e-2 · max|ref| (about two bf16 ulps of
the output scale: the rounding points agree but the accumulation order and
the softmax normalisation point differ)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from videotransformer_tpu.kernels import fused_ffn_pallas, fused_mhsa_pallas
from videotransformer_tpu_torch.kernels import _build, fused_ffn, fused_mhsa

BF16_REL = 1e-2


def _mhsa_args(B, N, D, seed):
    rng = np.random.RandomState(seed)
    return [
        rng.randn(B, N, D) * 0.5,
        rng.randn(D) * 0.1 + 1,
        rng.randn(D) * 0.1,
        rng.randn(D, 3 * D) * 0.08,  # (in, out): the JAX layout
        rng.randn(3 * D) * 0.05,
        rng.randn(D, D) * 0.08,
        rng.randn(D) * 0.05,
    ]


def _ffn_args(M, D, hidden, seed):
    rng = np.random.RandomState(seed)
    return [
        rng.randn(M, D) * 0.5,
        rng.randn(D) * 0.1 + 1,
        rng.randn(D) * 0.1,
        rng.randn(D, hidden) * 0.1,
        rng.randn(hidden) * 0.05,
        rng.randn(hidden, D) * 0.05,
        rng.randn(D) * 0.05,
    ]


def _to_jax(args, dtype):
    return [jnp.asarray(a, dtype) for a in args]


def _to_torch(args, dtype):
    """JAX (in, out) weights -> nn.Linear's (out, in)."""
    return [torch.tensor(a.T if i in (3, 5) else a).to(dtype).contiguous()
            for i, a in enumerate(args)]


def _assert_close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want.astype(jnp.float32) if hasattr(want, "astype")
                      else want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    else:
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= BF16_REL, err


MHSA_CASES = [
    # (B, N, heads, block_diag, add_residual)
    pytest.param(2, 65, 4, 0, True, id="dense-N65-res"),
    pytest.param(1, 197, 4, 0, False, id="dense-N197"),
    pytest.param(2, 64, 4, 8, False, id="blockdiag8-N64"),
    pytest.param(1, 128, 4, 8, True, id="blockdiag8-N128-chunked-res"),
    # L > 256: the lengths the card's long attention variant takes
    pytest.param(1, 264, 4, 0, True, id="long-N264-res"),
    pytest.param(1, 320, 4, 0, False, id="long-N320"),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,N,H,block_diag,res", MHSA_CASES)
def test_mhsa_plain_matches_jax(B, N, H, block_diag, res, dtype):
    D = 64
    args = _mhsa_args(B, N, D, seed=N + block_diag)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    scale = (D // H) ** -0.5
    got = fused_mhsa.fused_prenorm_mhsa(
        *_to_torch(args, tdt), H, scale, 1e-5, res, block_diag)
    assert got.dtype == tdt and got.shape == (B, N, D)
    jargs = _to_jax(args, jdt)
    twin = fused_mhsa_pallas._reference_jnp(
        *jargs, num_heads=H, scale=scale, ln_eps=1e-5, add_residual=res,
        block_diag=block_diag)
    with pltpu.force_tpu_interpret_mode():
        pallas = fused_mhsa_pallas.fused_prenorm_mhsa(
            *jargs, H, scale, 1e-5, res, block_diag)
    got = got.float().numpy()
    _assert_close(got, twin, dtype)
    _assert_close(got, pallas, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [150, 280])
def test_ffn_plain_matches_jax(M, dtype):
    D, hidden = 64, 256
    args = _ffn_args(M, D, hidden, seed=M)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    got = fused_ffn.fused_prenorm_ffn(*_to_torch(args, tdt), 1e-5)
    assert got.dtype == tdt and got.shape == (M, D)
    jargs = _to_jax(args, jdt)
    twin = fused_ffn_pallas._reference_jnp(*jargs, 1e-5)
    with pltpu.force_tpu_interpret_mode():
        pallas = fused_ffn_pallas.fused_prenorm_ffn(*jargs, 1e-5)
    got = got.float().numpy()
    _assert_close(got, twin, dtype)
    _assert_close(got, pallas, dtype)


def test_ffn_flattens_leading_dims():
    args = _to_torch(_ffn_args(24, 64, 128, seed=3), torch.float32)
    x3 = args[0].reshape(2, 3, 4, 64)
    out = fused_ffn.fused_prenorm_ffn(x3, *args[1:])
    assert out.shape == (2, 3, 4, 64)
    torch.testing.assert_close(out.reshape(24, 64),
                               fused_ffn.fused_prenorm_ffn(*args), rtol=0,
                               atol=0)


def test_block_diag_equals_independent_sequences():
    """block_diag=T on (B, N) is dense attention over (B·N/T, T) rows."""
    args = _to_torch(_mhsa_args(2, 32, 64, seed=5), torch.float32)
    packed = fused_mhsa.fused_prenorm_mhsa(*args, 4, 0.25, 1e-5, True, 8)
    split = fused_mhsa.fused_prenorm_mhsa(
        args[0].reshape(8, 8, 64), *args[1:], 4, 0.25, 1e-5, True, 0)
    torch.testing.assert_close(packed, split.reshape(2, 32, 64), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError, match="multiple of block_diag"):
        fused_mhsa.fused_prenorm_mhsa(*args, 4, 0.25, 1e-5, True, 5)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    m0, f0 = fused_mhsa.LAUNCHES, fused_ffn.LAUNCHES
    margs = _to_torch(_mhsa_args(2, 16, 64, seed=1), torch.bfloat16)
    fargs = _to_torch(_ffn_args(16, 64, 128, seed=1), torch.bfloat16)
    torch.testing.assert_close(
        fused_mhsa.fused_prenorm_mhsa(*margs, 4, 0.25),
        fused_mhsa.fused_prenorm_mhsa_reference(*margs, 4, 0.25),
        rtol=0, atol=0)
    torch.testing.assert_close(
        fused_ffn.fused_prenorm_ffn(*fargs),
        fused_ffn.fused_prenorm_ffn_reference(*fargs), rtol=0, atol=0)
    assert (fused_mhsa.LAUNCHES, fused_ffn.LAUNCHES) == (m0, f0)


@pytest.mark.parametrize("kernel", ["mhsa", "ffn"])
def test_non_cpu_tensor_never_falls_back(kernel):
    """Off the CPU a wrapper launches or raises: a tensor the kernel cannot
    take (here on the meta device) raises instead of running the plain
    version."""
    if kernel == "mhsa":
        args = [torch.empty(s, device="meta", dtype=torch.bfloat16)
                for s in [(2, 16, 64), (64,), (64,), (192, 64), (192,),
                          (64, 64), (64,)]]
        call = lambda: fused_mhsa.fused_prenorm_mhsa(*args, 4, 0.25)
    else:
        args = [torch.empty(s, device="meta", dtype=torch.bfloat16)
                for s in [(16, 64), (64,), (64,), (128, 64), (128,),
                          (64, 128), (64,)]]
        call = lambda: fused_ffn.fused_prenorm_ffn(*args)
    with pytest.raises(ValueError, match="expected cuda"):
        call()


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc: the build raises (and nothing falls back to a plain path)."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "empty-bin"))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build("fused_ffn", build_dir=str(tmp_path / "build"))
    assert not (tmp_path / "build").exists()


def test_build_reports_compiler_failure(monkeypatch, tmp_path):
    """A failing nvcc raises with the compiler's own output."""
    fake = tmp_path / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    fake.write_text("#!/bin/sh\necho 'error: fake compiler refused' >&2\n"
                    "exit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    with pytest.raises(_build.KernelBuildError, match="fake compiler refused"):
        _build.build("fused_mhsa", build_dir=str(tmp_path / "build"))
