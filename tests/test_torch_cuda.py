"""The port's CUDA kernels on a card, against their plain PyTorch versions.

These tests carry the ``cuda`` marker and skip without a card. They import
neither jax nor flax, so they run on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda

(``--noconftest``: tests/conftest.py sets up jax for the JAX package's tests.)
The plain version runs in fp32 from the same bf16 inputs; tolerance
1e-2 · max|plain|, about two bf16 ulps of the output scale."""

import numpy as np
import pytest
import torch

from videotransformer_tpu_torch.kernels import fused_ffn, fused_mhsa
from videotransformer_tpu_torch.models.timesformer import TimeSformer

REL_TOL = 1e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bf16(rng, shape, std, mean=0.0):
    a = rng.standard_normal(shape, dtype=np.float32) * std + mean
    return torch.from_numpy(a).to("cuda", torch.bfloat16)


def _rel_err(got, want):
    assert torch.isfinite(got).all()
    return float((got.float() - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,D,H,block_diag,res", [
    (3, 65, 64, 4, 0, True),        # ragged dense N
    (2, 197, 64, 4, 0, False),      # the spatial length
    (4, 64, 64, 4, 8, False),       # block-diagonal
    (5, 9, 64, 4, 9, True),         # a length-9 (cls + 8) temporal row
    (42, 896, 768, 12, 8, True),    # the JAX package's packed layout
    (16, 197, 768, 12, 0, False),   # spatial at full width
    (2, 600, 64, 4, 0, True),       # too long for the tensor-core stage
])
def test_mhsa_kernel_matches_plain(cuda_device, B, N, D, H, block_diag, res):
    rng = np.random.default_rng(N + D)
    args = [_bf16(rng, (B, N, D), 1.0), _bf16(rng, (D,), 0.1, 1.0),
            _bf16(rng, (D,), 0.1), _bf16(rng, (3 * D, D), 0.03),
            _bf16(rng, (3 * D,), 0.03), _bf16(rng, (D, D), 0.03),
            _bf16(rng, (D,), 0.03)]
    tail = (H, (D // H) ** -0.5, 1e-5, res, block_diag)
    n0 = fused_mhsa.LAUNCHES
    out = fused_mhsa.fused_prenorm_mhsa(*args, *tail)
    torch.cuda.synchronize()
    assert fused_mhsa.LAUNCHES == n0 + 1
    want = fused_mhsa.fused_prenorm_mhsa_reference(
        *[a.float() for a in args], *tail)
    assert out.shape == want.shape and out.dtype == torch.bfloat16
    assert _rel_err(out, want) <= REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("M,D,hidden", [(150, 64, 256), (1000, 768, 3072)])
def test_ffn_kernel_matches_plain(cuda_device, M, D, hidden):
    rng = np.random.default_rng(M)
    args = [_bf16(rng, (M, D), 1.0), _bf16(rng, (D,), 0.1, 1.0),
            _bf16(rng, (D,), 0.1), _bf16(rng, (hidden, D), 0.03),
            _bf16(rng, (hidden,), 0.03), _bf16(rng, (D, hidden), 0.03),
            _bf16(rng, (D,), 0.03)]
    n0 = fused_ffn.LAUNCHES
    out = fused_ffn.fused_prenorm_ffn(*args)
    torch.cuda.synchronize()
    assert fused_ffn.LAUNCHES == n0 + 1
    want = fused_ffn.fused_prenorm_ffn_reference(*[a.float() for a in args])
    assert _rel_err(out, want) <= REL_TOL


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(cuda_device):
    rng = np.random.default_rng(0)
    args = [_bf16(rng, s, 0.1) for s in
            [(16, 64), (64,), (64,), (128, 64), (128,), (64, 128), (64,)]]
    with pytest.raises(TypeError, match="expected bfloat16"):
        fused_ffn.fused_prenorm_ffn(args[0].float(), *args[1:])
    with pytest.raises(ValueError, match="not contiguous"):
        fused_ffn.fused_prenorm_ffn(args[0].t().contiguous().t(), *args[1:])
    d96 = [_bf16(rng, s, 0.1) for s in
           [(16, 96), (96,), (96,), (128, 96), (128,), (96, 128), (96,)]]
    with pytest.raises(ValueError, match="multiples of 64"):
        fused_ffn.fused_prenorm_ffn(*d96)


@pytest.mark.cuda
def test_tiny_model_on_card_matches_cpu(cuda_device):
    """A 2-layer D=64 TimeSformer in bf16: the card (kernels) against the
    CPU (plain versions) from the same weights and clip."""
    model = TimeSformer(num_frames=4, img_size=128, embed_dims=64,
                        num_heads=4, num_transformer_layers=2)
    model.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():  # make the zero-initialised temporal_fc count
        for layer in model.transformer_layers.layers:
            fc = layer.attentions[0].temporal_fc
            fc.weight.normal_(0, 0.05, generator=torch.Generator().manual_seed(1))
    clip = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 4, 3, 128, 128), dtype=np.float32)).to(torch.bfloat16)
    model = model.to(torch.bfloat16).eval()
    with torch.inference_mode():
        cpu = model(clip).float()
        m0, f0 = fused_mhsa.LAUNCHES, fused_ffn.LAUNCHES
        gpu = model.to(cuda_device)(clip.to(cuda_device)).float().cpu()
    assert (fused_mhsa.LAUNCHES - m0, fused_ffn.LAUNCHES - f0) == (4, 2)
    assert _rel_err(gpu, cpu) <= 5e-2
